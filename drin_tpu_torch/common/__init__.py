"""Configuration, CLI overrides and .npy reading: the port's own copies of the
jax-free ``drin_tpu/common`` modules it needs."""
