"""Graph substrate: host container, the R-MAT and community generators,
and synthetic stand-ins for the paper's Table-1 datasets (no downloads:
graphs are synthesized with matching vertex/edge/feature/class
statistics, scaled by a factor).

Counterpart of ``repro/graphs/graph.py``.  Pure numpy, so the same seed
gives byte-identical arrays in both packages."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass
class Graph:
    """Host-side graph. senders/receivers are the COO (src, dst) edge list;
    by GNN convention aggregation is over in-neighbors: dst row, src col."""
    n: int
    senders: np.ndarray     # (E,) int32
    receivers: np.ndarray   # (E,) int32
    features: np.ndarray    # (n, F) float32
    labels: np.ndarray      # (n,) int32
    n_classes: int
    name: str = "graph"

    @property
    def n_edges(self) -> int:
        return int(self.senders.shape[0])


def rmat(n: int, n_edges: int, seed: int = 0, a: float = 0.57,
         b: float = 0.19, c: float = 0.19) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT recursive generator (Chakrabarti et al., SDM'04), the paper's
    density sweep (§2.1).  Returns deduplicated (src, dst), int32."""
    rng = np.random.default_rng(seed)
    scale = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    m = int(n_edges * 1.2) + 16  # oversample; dedup below
    # each level picks a quadrant with probs (a, b, c, d): the src bit is
    # set for the bottom half (c, d), the dst bit for the right half (b, d)
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(scale):
        r = rng.random(m)
        src_bit = (r > a + b).astype(np.int64)
        dst_bit = (((r > a) & (r <= a + b)) | (r > a + b + c)).astype(np.int64)
        src = src * 2 + src_bit
        dst = dst * 2 + dst_bit
    src %= n
    dst %= n
    eid = src * n + dst
    _, keep = np.unique(eid, return_index=True)
    keep = keep[: n_edges]
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


def community_graph(n: int, n_edges: int, comm_size: int = 16,
                    intra_frac: float = 0.7, seed: int = 0
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Planted-partition generator: community structure with a
    controllable intra-community edge fraction, deduplicated."""
    rng = np.random.default_rng(seed)
    n_intra = int(n_edges * intra_frac)
    n_inter = n_edges - n_intra
    comm = rng.permutation(n)  # hide the communities behind a random labeling
    # intra edges: pick a community block, then two members
    n_comm = max(n // comm_size, 1)
    cblock = rng.integers(0, n_comm, n_intra)
    base = cblock * comm_size
    s_in = base + rng.integers(0, comm_size, n_intra)
    d_in = base + rng.integers(0, comm_size, n_intra)
    s_out = rng.integers(0, n, n_inter)
    d_out = rng.integers(0, n, n_inter)
    src = np.concatenate([s_in, s_out]) % n
    dst = np.concatenate([d_in, d_out]) % n
    src, dst = comm[src], comm[dst]   # apply hiding permutation
    eid = src.astype(np.int64) * n + dst
    _, keep = np.unique(eid, return_index=True)
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


def aligned_community_graph(n: int, n_edges: int, block: int = 128,
                            intra_frac: float = 0.9, seed: int = 0
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Block-diagonal-dominant graph with aligned communities: intra edges
    land on size-``block`` diagonal blocks directly (decompose it with
    ``reorder=False``), inter edges join neighbouring communities in a
    ring, so the off-diagonal blocks are few and coherent (small
    blocked-ELL K): where the dense intra kernel and the fused
    transform+aggregate pass dominate.  Deduplicated (src, dst), int32."""
    rng = np.random.default_rng(seed)
    nb = max(n // block, 1)
    n_intra = int(n_edges * intra_frac)
    n_inter = n_edges - n_intra
    cb = rng.integers(0, nb, n_intra) * block
    s_in = cb + rng.integers(0, block, n_intra)
    d_in = cb + rng.integers(0, block, n_intra)
    rb = rng.integers(0, nb, n_inter)
    s_out = ((rb + 1) % nb) * block + rng.integers(0, block, n_inter)
    d_out = rb * block + rng.integers(0, block, n_inter)
    src = np.concatenate([s_in, s_out]) % n
    dst = np.concatenate([d_in, d_out]) % n
    eid = src.astype(np.int64) * n + dst
    _, keep = np.unique(eid, return_index=True)
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


# (#vertex, #edge, #feat, #class) from paper Table 1.
TABLE1 = {
    "cora": (2708, 10556, 1433, 7),
    "citeseer": (3327, 9228, 3703, 6),
    "pubmed": (19717, 99203, 500, 3),
    "proteins_full": (43466, 162088, 29, 2),
    "artist": (50515, 1638396, 100, 12),
    "ppi": (56944, 818716, 50, 121),
    "soc_blogcatalog": (88784, 2093195, 128, 39),
    "com_amazon": (334863, 1851744, 96, 22),
    "dd": (334925, 1686092, 89, 2),
    "amazon0601": (403394, 3387388, 96, 22),
    "amazon0505": (410236, 4878874, 96, 22),
    "twitter_partial": (580768, 1435116, 1323, 2),
    "yeast": (1710902, 3636546, 74, 2),
    "sw_620h": (1888584, 3944206, 66, 2),
    "ovcar_8h": (1889542, 3946402, 66, 2),
}


def synth_dataset(name: str, scale: float = 1.0, seed: int = 0,
                  comm_size: int = 16, intra_frac: float = 0.6,
                  max_feat: int | None = None) -> Graph:
    """Synthetic dataset matching a Table-1 row's statistics, optionally
    downscaled."""
    nv, ne, nf, nc = TABLE1[name]
    n = max(int(nv * scale), 2 * comm_size)
    e = max(int(ne * scale), n)
    if max_feat is not None:
        nf = min(nf, max_feat)
    src, dst = community_graph(n, e, comm_size=comm_size,
                               intra_frac=intra_frac, seed=seed)
    rng = np.random.default_rng(seed + 1)
    feats = rng.standard_normal((n, nf)).astype(np.float32) * 0.1
    labels = rng.integers(0, nc, n).astype(np.int32)
    return Graph(n, src, dst, feats, labels, nc, name=name)


def add_self_loops(g: Graph) -> Graph:
    loop = np.arange(g.n, dtype=np.int32)
    return dataclasses.replace(
        g, senders=np.concatenate([g.senders, loop]),
        receivers=np.concatenate([g.receivers, loop]))


def gcn_norm_values(n: int, senders: np.ndarray,
                    receivers: np.ndarray) -> np.ndarray:
    """Symmetric GCN normalization D^-1/2 (A) D^-1/2 per edge (Kipf&Welling)."""
    deg = np.bincount(receivers, minlength=n).astype(np.float32)
    deg_in = np.bincount(senders, minlength=n).astype(np.float32)
    d = np.maximum(deg, 1.0) ** -0.5
    ds = np.maximum(deg_in, 1.0) ** -0.5
    return (d[receivers] * ds[senders]).astype(np.float32)


def mean_norm_values(n: int, senders: np.ndarray,
                     receivers: np.ndarray) -> np.ndarray:
    """Mean-aggregation normalization 1/deg(dst) per edge (SAGE), with
    deg clamped to at least 1.  Baked into the edge values like the GCN
    norm, so ``A @ x`` is the in-neighbour mean."""
    deg = np.bincount(receivers, minlength=n).astype(np.float32)
    inv = 1.0 / np.maximum(deg, 1.0)
    return inv[receivers].astype(np.float32)
