"""Graph-level readout pools (counterpart of ``egc_tpu.nn.pool``): masked
segment reductions of node rows over their graph ids, PyG's
``global_{add,mean,max}_pool`` with explicit padding masks. An empty graph
slot (a padding graph) gives 0 for each of them, max included."""

from __future__ import annotations

from egc_tpu_torch.ops.segment import segment_max, segment_mean, segment_sum


def global_add_pool(x, graph_ids, num_graphs: int, node_mask=None):
    return segment_sum(x, graph_ids, num_graphs, mask=node_mask)


def global_mean_pool(x, graph_ids, num_graphs: int, node_mask=None):
    return segment_mean(x, graph_ids, num_graphs, mask=node_mask)


def global_max_pool(x, graph_ids, num_graphs: int, node_mask=None):
    return segment_max(x, graph_ids, num_graphs, mask=node_mask)


_POOLS = {
    "mean": global_mean_pool,
    "sum": global_add_pool,
    "add": global_add_pool,
    "max": global_max_pool,
}


def get_pool(name: str):
    if name not in _POOLS:
        raise ValueError(f"unknown readout {name!r}; supported "
                         f"{sorted(_POOLS)}")
    return _POOLS[name]
