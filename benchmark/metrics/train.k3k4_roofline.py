"""train.k3k4_roofline: (K3's bound + K4's bound) at the step's shapes
(`benchmark.bounds.k3_bound_s`, `k4_bound_s`) times the steps that ran
them in the traced window, over the device time of their kernels, in %.
One step launches K3 once and K4 once; K4 is four kernels."""

K3 = ("conv2_pool_fwd_wgmma",)
K4 = ("conv2_pool_route_wgmma", "conv2_wgrad_wgmma", "wgrad_reduce",
      "conv2_dgrad_wgmma")


def read(t):
    b3, b4 = t.work.get("k3_bound_s"), t.work.get("k4_bound_s")
    s3, n3 = t.kernel_seconds(*K3)
    s4, n4 = t.kernel_seconds(*K4)
    route, n_route = t.kernel_seconds("conv2_pool_route_wgmma")
    if not b3 or not n3 or not n_route or s3 + s4 <= 0:
        return None
    return 100.0 * (b3 * n3 + b4 * n_route) / (s3 + s4)
