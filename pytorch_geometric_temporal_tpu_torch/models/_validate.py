"""Actionable input validation shared by model entry points."""

from __future__ import annotations


def _num_nodes(graph) -> int:
    src = getattr(graph, "src_count", None)
    return src if src is not None else graph.num_nodes


def check_node_axis(x, graph, model: str, layout: str, axis: int = -2):
    """Raise a layout-naming error when x's node axis does not match the
    graph."""
    n = _num_nodes(graph)
    if x.shape[axis] != n:
        raise ValueError(
            f"{model} expects input laid out as {layout} with the node axis "
            f"(axis {axis}) equal to the graph's {n} nodes; got input shape "
            f"{tuple(x.shape)}. Check the axis order — use torch.movedim / "
            f"permute if your data uses another layout."
        )


def check_rank(x, model: str, layout: str, ranks):
    if isinstance(ranks, int):
        ranks = (ranks,)
    if x.dim() not in ranks:
        expect = " or ".join(f"rank {r}" for r in ranks)
        raise ValueError(
            f"{model} expects input {layout} ({expect}); got rank {x.dim()} "
            f"(shape {tuple(x.shape)})."
        )
