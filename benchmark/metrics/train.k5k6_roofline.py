"""train.k5k6_roofline: (K5's bound + K6's bound) at the step's shapes
(`benchmark.bounds.k5_bound_s`, `k6_bound_s`) times the launches in the
traced window, over the device time of their kernels, in %. K5 is
`costail_fwd_*` and `costail_finalize`, K6 `costail_bwd_*`."""

K5 = ("costail_fwd_", "costail_finalize")
K6 = ("costail_bwd_",)


def read(t):
    b5, b6 = t.work.get("k5_bound_s"), t.work.get("k6_bound_s")
    s5, _ = t.kernel_seconds(*K5)
    _, n5 = t.kernel_seconds("costail_fwd_")
    s6, n6 = t.kernel_seconds(*K6)
    if not b5 or not n5 or not n6 or s5 + s6 <= 0:
        return None
    return 100.0 * (b5 * n5 + b6 * n6) / (s5 + s6)
