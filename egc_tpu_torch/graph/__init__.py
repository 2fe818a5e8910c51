"""Graph containers and transforms (counterpart of ``egc_tpu.graph``)."""

from egc_tpu_torch.graph.structure import (  # noqa: F401
    Graph, batch_np, pad_graph,
)
