"""Share of the traced window in which the device runs no kernel, copy or
memset, in percent."""


def read(m):
    return 100.0 * (1.0 - m.trace.busy_s() / m.trace.window_s())
