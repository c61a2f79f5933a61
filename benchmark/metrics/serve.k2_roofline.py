"""serve.k2_roofline: K2's bound at the request's shapes
(`benchmark.bounds.k2_bound_s`, the padded block-1 input of the bucket)
times its launches in the traced window, over the device time of those
launches (kernels named `block1_fused_wgmma`), in %."""

KERNELS = ("block1_fused_wgmma",)


def read(t):
    bound = t.work.get("k2_bound_s")
    sec, n = t.kernel_seconds(*KERNELS)
    if not bound or not n or sec <= 0:
        return None
    return 100.0 * bound * n / sec
