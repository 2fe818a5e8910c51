"""Device milliseconds a full-graph step of the dense matrix products:
the kernels cuBLAS and CUTLASS name as GEMMs (and GEMVs, and cuBLAS's
split-K reduction)."""

from gnnbench.trace import matching

KERNELS = ("gemm", "gemv", "xmma", "cutlass", "splitKreduce")


def read(r):
    if r["mode"] != "full" or "profile" not in r:
        return None
    prof = r["profile"]
    return 1e3 * matching(prof["ops"], KERNELS) / prof["steps"]
