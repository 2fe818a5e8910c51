"""Graph containers and transforms (counterpart of ``egc_tpu.graph``)."""

from egc_tpu_torch.graph.structure import Graph, pad_graph  # noqa: F401
