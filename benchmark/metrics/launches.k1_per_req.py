"""launches.k1_per_req: K1's launches (the port's own counter,
`ops._kernels.launch_counts["szn_fused"]`) per request over the traced
window: 1 where each request's labels come from the fused kernel."""


def read(t):
    n = t.work.get("requests")
    if not n or "k1_launches" not in t.work:
        return None
    return t.work["k1_launches"] / n
