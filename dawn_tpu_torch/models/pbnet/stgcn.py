"""ST-GCN action recognizer — the feature extractor behind the PBnet
STGCN metric suite.

Port of ``dawn_tpu/models/pbnet/stgcn.py`` (PBnet/src/recognition/models/
stgcn.py:1-219 + stgcnutils/graph.py:1-175 + stgcnutils/tgcn.py:34-63):

- :func:`build_graph`, numpy, copied: every built-in layout ('openpose',
  'ntu-rgb+d', 'ntu_edge' and the 8-node 'dawn_head' over the PBnet
  channels) and every partition strategy ('uniform', 'distance',
  'spatial'), or an explicit edge list;
- :class:`STGCN`, an ``nn.Module`` in the reference's own layout (NCTV
  inside, the reference's state-dict names: ``A``, ``data_bn``,
  ``st_gcn_networks.{i}.gcn.conv``, ``.tcn.{0,2,3}``, ``.residual.{0,1}``,
  ``edge_importance.{i}``, ``fcn``), so a released recognizer ``.tar``
  loads with a strict ``load_state_dict`` and the JAX package's
  ``convert_stgcn`` reads the port's ``state_dict()``.

Inputs are (N, T, V, C) single-skeleton motions, as in the JAX package.
``data_bn`` normalises the V*C channels in the order v*C + c; the graph
conv groups its K*C' output channels K-major before the contraction; the
BatchNorms' momentum is torch's 0.1 (flax's 0.9).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# --------------------------------------------------------------------- graphs

def _hop_distance(num_node: int, edges: Sequence[Tuple[int, int]],
                  max_hop: int = 1) -> np.ndarray:
    """BFS hop counts via adjacency powers (graph.py:150-162)."""
    a = np.zeros((num_node, num_node))
    for i, j in edges:
        a[j, i] = 1
        a[i, j] = 1
    hop = np.full((num_node, num_node), np.inf)
    powers = [np.linalg.matrix_power(a, d) for d in range(max_hop + 1)]
    arrive = np.stack(powers) > 0
    for d in range(max_hop, -1, -1):
        hop[arrive[d]] = d
    return hop


def _normalize_digraph(a: np.ndarray) -> np.ndarray:
    """Column-degree normalization A @ D^-1 (graph.py:165-173)."""
    deg = a.sum(0)
    dn = np.zeros_like(a)
    idx = deg > 0
    dn[np.where(idx)[0], np.where(idx)[0]] = deg[idx] ** -1
    return a @ dn


# reference layouts with self-contained edge lists (graph.py:47-95);
# 'smpl'/'smpl_noglobal' need the kintree pickle -> pass edges= instead.
_LAYOUTS: Dict[str, dict] = {
    "openpose": dict(
        num_node=18, center=1,
        neighbors=[(4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11),
                   (10, 9), (9, 8), (11, 5), (8, 2), (5, 1), (2, 1),
                   (0, 1), (15, 0), (14, 0), (17, 15), (16, 14)]),
    "ntu-rgb+d": dict(
        num_node=25, center=20,
        neighbors=[(i - 1, j - 1) for (i, j) in
                   [(1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5),
                    (7, 6), (8, 7), (9, 21), (10, 9), (11, 10), (12, 11),
                    (13, 1), (14, 13), (15, 14), (16, 15), (17, 1), (18, 17),
                    (19, 18), (20, 19), (22, 23), (23, 8), (24, 25),
                    (25, 12)]]),
    "ntu_edge": dict(
        num_node=24, center=2,
        neighbors=[(i - 1, j - 1) for (i, j) in
                   [(1, 2), (3, 2), (4, 3), (5, 2), (6, 5), (7, 6), (8, 7),
                    (9, 2), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13),
                    (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
                    (20, 19), (21, 22), (22, 8), (23, 24), (24, 12)]]),
    # DAWN head-motion graph (this repo's design, no reference analogue):
    # nodes = the 8 PBnet channels [yaw, pitch, roll, tx, ty, tz, blink_l,
    # blink_r] as V=8 / C=1; rotation star at 0, translation star at 3
    # bridged to 0, eyes linked to each other and the rotation root.
    "dawn_head": dict(
        num_node=8, center=0,
        neighbors=[(1, 0), (2, 0), (3, 0), (4, 3), (5, 3),
                   (6, 0), (7, 0), (6, 7)]),
}


def build_graph(layout: str = "openpose", strategy: str = "spatial",
                edges: Optional[Sequence[Tuple[int, int]]] = None,
                num_node: Optional[int] = None, center: int = 0,
                max_hop: int = 1, dilation: int = 1) -> np.ndarray:
    """Adjacency stack A (K, V, V) per graph.py:101-146.

    strategy: 'uniform' (K=1), 'distance' (K=hops), 'spatial'
    (K=1+2*hops: root / centripetal / centrifugal partitions).
    Pass ``edges`` (+ num_node, center) for custom skeletons (e.g. the
    SMPL kintree pairs); otherwise ``layout`` picks a built-in.
    """
    if edges is None:
        spec = _LAYOUTS[layout]
        num_node, center = spec["num_node"], spec["center"]
        neighbors = spec["neighbors"]
    else:
        assert num_node is not None, "explicit edges need num_node"
        neighbors = [tuple(e) for e in edges]
    edge = [(i, i) for i in range(num_node)] + list(neighbors)

    hop = _hop_distance(num_node, edge, max_hop=max_hop)
    valid_hop = range(0, max_hop + 1, dilation)
    adjacency = np.zeros((num_node, num_node))
    for h in valid_hop:
        adjacency[hop == h] = 1
    norm_adj = _normalize_digraph(adjacency)

    if strategy == "uniform":
        return norm_adj[None].astype(np.float32)
    if strategy == "distance":
        a = np.zeros((len(list(valid_hop)), num_node, num_node))
        for i, h in enumerate(valid_hop):
            a[i][hop == h] = norm_adj[hop == h]
        return a.astype(np.float32)
    if strategy == "spatial":
        parts = []
        for h in valid_hop:
            a_root = np.zeros((num_node, num_node))
            a_close = np.zeros((num_node, num_node))
            a_further = np.zeros((num_node, num_node))
            for i in range(num_node):
                for j in range(num_node):
                    if hop[j, i] != h:
                        continue
                    if hop[j, center] == hop[i, center]:
                        a_root[j, i] = norm_adj[j, i]
                    elif hop[j, center] > hop[i, center]:
                        a_close[j, i] = norm_adj[j, i]
                    else:
                        a_further[j, i] = norm_adj[j, i]
            if h == 0:
                parts.append(a_root)
            else:
                parts.append(a_root + a_close)
                parts.append(a_further)
        return np.stack(parts).astype(np.float32)
    raise NotImplementedError(f"strategy {strategy!r}")


# --------------------------------------------------------------------- model

class STGCNBlock(nn.Module):
    """One st_gcn unit (stgcn.py:139-216): graph conv -> 9-frame temporal
    conv, BN/ReLU plumbing and the three residual modes (none, identity,
    conv). The reference's dropout after the temporal conv (tcn.4) is left
    out: the recognizer only scores, in eval mode."""

    def __init__(self, in_channels: int, out_channels: int, spatial_kernel: int,
                 stride: int = 1, residual: bool = True):
        super().__init__()
        self.spatial_kernel = spatial_kernel
        self.gcn = nn.Module()
        self.gcn.conv = nn.Conv2d(in_channels, out_channels * spatial_kernel, 1)
        self.tcn = nn.Sequential(
            nn.BatchNorm2d(out_channels), nn.ReLU(inplace=True),
            nn.Conv2d(out_channels, out_channels, (9, 1), (stride, 1), (4, 0)),
            nn.BatchNorm2d(out_channels))
        if not residual:
            self.residual_mode = "none"
        elif in_channels == out_channels and stride == 1:
            self.residual_mode = "identity"
        else:
            self.residual_mode = "conv"
            self.residual = nn.Sequential(
                nn.Conv2d(in_channels, out_channels, 1, stride=(stride, 1)),
                nn.BatchNorm2d(out_channels))

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """x (N, C, T, V), a (K, V, V) -> (N, C', T', V)."""
        if self.residual_mode == "conv":
            res = self.residual(x)
        else:
            res = x if self.residual_mode == "identity" else 0.0
        y = self.gcn.conv(x)
        n, kc, t, v = y.shape
        y = y.view(n, self.spatial_kernel, kc // self.spatial_kernel, t, v)
        y = torch.einsum("nkctv,kvw->nctw", y, a)
        return F.relu(self.tcn(y) + res)


# (out channels, temporal stride, residual) of the ten blocks (stgcn.py:51-62)
BLOCKS = ((64, 1, False), (64, 1, True), (64, 1, True), (64, 1, True), (128, 2, True),
          (128, 1, True), (128, 1, True), (256, 2, True), (256, 1, True), (256, 1, True))


class STGCN(nn.Module):
    """Spatial-temporal graph conv recognizer (stgcn.py:11-135).

    ``forward`` takes (N, T, V, in_channels) motions and returns
    {'features': (N, 256) pooled activations — the FID/diversity feature
    space — and 'yhat': (N, num_class) logits}. ``graph`` is the (K, V, V)
    adjacency stack of :func:`build_graph` or a reference checkpoint's 'A'
    buffer; it is the module's ``A`` buffer, as in the reference."""

    def __init__(self, in_channels: int, num_class: int, graph: np.ndarray,
                 edge_importance_weighting: bool = True):
        super().__init__()
        self.in_channels, self.num_class = in_channels, num_class
        self.edge_importance_weighting = edge_importance_weighting
        self.register_buffer("A", torch.as_tensor(np.asarray(graph, np.float32)))
        k, v, _ = self.A.shape
        self.data_bn = nn.BatchNorm1d(in_channels * v)
        blocks, cin = [], in_channels
        for out, stride, residual in BLOCKS:
            blocks.append(STGCNBlock(cin, out, k, stride=stride, residual=residual))
            cin = out
        self.st_gcn_networks = nn.ModuleList(blocks)
        if edge_importance_weighting:
            self.edge_importance = nn.ParameterList(
                nn.Parameter(torch.ones(k, v, v)) for _ in BLOCKS)
        self.fcn = nn.Conv2d(BLOCKS[-1][0], num_class, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        n, t, v, c = x.shape
        k, v_nodes, _ = self.A.shape
        if v != v_nodes or c != self.in_channels:
            raise ValueError(f"motions {tuple(x.shape)} do not fit the graph's V={v_nodes} "
                             f"and C={self.in_channels}")
        # data_bn over the V*C channels in the order v*C + c (stgcn.py:87-92)
        h = self.data_bn(x.permute(0, 2, 3, 1).reshape(n, v * c, t))
        h = h.reshape(n, v, c, t).permute(0, 2, 3, 1)                  # (N, C, T, V)
        for i, block in enumerate(self.st_gcn_networks):
            a = self.A * self.edge_importance[i] if self.edge_importance_weighting else self.A
            h = block(h, a)
        feats = h.mean(dim=(2, 3))                                     # global (T, V) pool
        logits = self.fcn(feats[:, :, None, None])[:, :, 0, 0]
        return {"features": feats, "yhat": logits}
