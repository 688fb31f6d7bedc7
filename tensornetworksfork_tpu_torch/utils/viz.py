"""Topology visualisation (port of tensornetworksfork_tpu/utils/viz.py):
the node graph drawn with networkx and matplotlib when both import, else
the JAX package's ASCII listing of columns and edges (what runs on the
card's machine, which has neither)."""
from __future__ import annotations

from typing import Optional

from ..core.topology import INPUT, PARAM, Topology


def topology_edges(topology: Topology):
    """(node a, node b, axis) for each bond between consecutive carriers of
    an axis, the sample axis excluded."""
    edges = []
    for aid, carriers in topology.axis_nodes.items():
        if aid == topology.sample_axis or len(carriers) < 2:
            continue
        for a, b in zip(carriers[:-1], carriers[1:]):
            edges.append((a, b, aid))
    return edges


def topology_text(topology: Topology) -> str:
    """The ASCII listing: each column's nodes (name and kind), then each
    edge."""
    lines = ["topology:"]
    for ci, col in enumerate(topology.columns):
        names = ", ".join(f"{topology.nodes[n].name}({topology.nodes[n].kind})" for n in col)
        lines.append(f"  column {ci}: {names}")
    for a, b, aid in topology_edges(topology):
        lines.append(f"  {topology.nodes[a].name} --{aid}-- {topology.nodes[b].name}")
    return "\n".join(lines)


def visualize_topology(topology: Topology, path: Optional[str] = None):
    """Draw (or print) the network graph. Returns the figure or the ASCII
    string (written to `path` if given)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import networkx as nx
    except Exception:
        text = topology_text(topology)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    g = nx.Graph()
    colors = []
    pos = {}
    for ni, spec in enumerate(topology.nodes):
        g.add_node(spec.name)
        colors.append({PARAM: "#4a90d9", INPUT: "#7bc67b"}.get(spec.kind, "#c9c9c9"))
        ci = topology.col_of[ni]
        pos[spec.name] = (ci, -topology.columns[ci].index(ni))
    for a, b, _ in topology_edges(topology):
        g.add_edge(topology.nodes[a].name, topology.nodes[b].name)
    fig, ax = plt.subplots(figsize=(1.5 * len(topology.columns) + 2, 4))
    nx.draw(g, pos=pos, ax=ax, with_labels=True, node_color=colors, node_size=900,
            font_size=8)
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
    return fig
