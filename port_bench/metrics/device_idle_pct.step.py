"""device_idle_pct.step: the share of the traced window of replayed steps
in which no operation ran on the device, in percent: 100 (1 - the union of
the device operations' intervals / the window), the window on the host's
clock from the block's first call to its closing synchronisation."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
