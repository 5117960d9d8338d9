"""The frozen operation and byte counts against the figures the port's chip
smoke run printed for its kernels (PERF.md's table of kernels), and the
model FLOPs behind ``mfu.*``."""

import json
import os

import pytest

from portbench import counts, harness


def _peaks():
    with open(os.path.join(harness.PKG, "peaks.json")) as f:
        return json.load(f)


def test_kernel1_operations_and_bound():
    assert counts.gcn_layer_flops(64, 101, 768) / 1e9 == pytest.approx(15.70, abs=0.005)
    nbytes = counts.gcn_layer_bytes(64, 101, 768, "float32")
    assert nbytes / 1e6 == pytest.approx(87.5, abs=0.05)
    bound = counts.bound_s(nbytes, counts.gcn_layer_flops(64, 101, 768), "float32",
                           _peaks())
    assert bound * 1e3 == pytest.approx(0.0952, abs=5e-5)  # the TF32 route bounds it


def test_kernel2_drin_slab_bytes():
    assert counts.gather_bytes(64 * 101, counts.DRIN_SLAB, "bfloat16") / 1e6 == \
        pytest.approx(110.4, abs=0.05)
    # float32 out, as the float32 DRIN serves: the output doubles
    assert counts.gather_bytes(64 * 101, counts.DRIN_SLAB, "float32") / 1e6 == \
        pytest.approx(183.2, abs=0.05)


def test_kernel3_bytes_and_operations():
    assert counts.attention_bytes(96, 12, 512, "bfloat16") / 1e6 == pytest.approx(302.1, abs=0.05)
    assert counts.attention_flops(96, 12, 512) / 1e9 == pytest.approx(77.3, abs=0.05)
    # the float32 form at BertStage's [64, 12, 512, 64]: 3 x 51.5 GFLOP of TF32
    assert counts.attention_flops(64, 12, 512) / 1e9 == pytest.approx(51.5, abs=0.05)
    bound = counts.bound_s(counts.attention_bytes(64, 12, 512, "float32"),
                           counts.attention_flops(64, 12, 512), "float32", _peaks())
    assert bound * 1e3 == pytest.approx(0.3124, abs=5e-4)


def test_model_flops():
    drin = {"bert_embed_dim": 768, "gcn_embed_dim": 768, "resnet_embed_dim": 2048,
            "mention_object_topk": 3, "entity_object_topk": 1, "num_gcn_layers": 2,
            "mention_final_output_dim": 768, "entity_final_output_dim": 768}
    fwd = counts.drin_flops(drin, 64, 101)
    assert fwd / 1e9 == pytest.approx(59.7, abs=0.05)
    train = counts.drin_flops(drin, 64, 101, train=True)
    encoders = 2 * (64 * 768 * 768 + 6464 * 768 * 768 + 64 * 2048 * 768 + 6464 * 2048 * 768)
    assert train == pytest.approx(fwd + encoders + 2 * 2 * counts.gcn_layer_flops(64, 101, 768))
    bert = {"hidden_size": 768, "intermediate_size": 3072, "num_hidden_layers": 12}
    # ~170 MFLOP a token through bert-base's products
    per_token = (counts.bert_flops(bert, 1, 1) - 2 * 768 * 768 - 12 * 4 * 768) / 1
    assert per_token / 1e6 == pytest.approx(169.9, abs=0.05)
    online = {"bert": bert, "bert_embed_dim": 768, "resnet_embed_dim": 2048,
              "resnet_num_region": 49, "max_mention_sentence_len": 128,
              "mention_final_output_dim": 768, "entity_final_output_dim": 768,
              "num_candidates_data": 100}
    # a request of 8 mentions, 96 zipped sentences at bucket 384: ~7 TFLOP
    assert counts.ghmfc_online_flops(online, 8, 128, 12, 384) / 1e12 == pytest.approx(7.0, abs=0.1)
