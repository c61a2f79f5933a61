"""serve.idle_share: the share of the traced serving window (%) in which
no kernel, copy or memset ran on the device (the union of the device's
intervals, so overlapping work counts once)."""


def read(t):
    if t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
