"""serve.k1_roofline: K1's bound at the request's shapes
(`benchmark.bounds.k1_bound_s`) times its launches in the traced window,
over the device time of those launches (kernels named
`szn_labels_kernel`), in %."""

KERNELS = ("szn_labels_kernel",)


def read(t):
    bound = t.work.get("k1_bound_s")
    sec, n = t.kernel_seconds(*KERNELS)
    if not bound or not n or sec <= 0:
        return None
    return 100.0 * bound * n / sec
