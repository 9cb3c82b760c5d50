"""GraphSAINT-style GCN training on C-SAW sampled subgraphs, on the PyTorch
port (the counterpart of ``graphsaint_gcn.py``).

The paper's own downstream partner (§VI compares against GraphSAINT):
sample subgraphs with the C-SAW engine (MDRW / frontier sampling, the
GraphSAINT random-walk sampler), train a 2-layer GCN on each sampled
subgraph, evaluate on the full graph.  Task: community detection on a
planted-partition (SBM) graph.  Sampling and training run on the card
unless ``--device cpu``:

    PYTHONPATH=src python examples/graphsaint_gcn_torch.py
    PYTHONPATH=src python examples/graphsaint_gcn_torch.py --device cpu

The graph, the features and every round's pools, keys and sampled vertices
are ``graphsaint_gcn.py``'s.  The initial weights are not: that example
draws them with ``jax.random.normal``, this one from a seeded
``torch.Generator``; ``train`` takes them as arguments, so the same
weights can start both.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.engine import traversal_sample  # noqa: E402
from repro_torch.graph.csr import csr_from_edges, resolve_device  # noqa: E402

FEAT_DIM, HIDDEN, LR = 32, 64, 0.1


def sbm_graph(n=1200, k=4, p_in=0.06, p_out=0.002, seed=0, device="cuda"):
    rng_ = np.random.default_rng(seed)
    labels = rng_.integers(0, k, n)
    src, dst = [], []
    for c in range(k):
        idx = np.where(labels == c)[0]
        m = rng_.random((len(idx), len(idx))) < p_in
        s, d = np.where(np.triu(m, 1))
        src += list(idx[s]); dst += list(idx[d])
    m = rng_.random((n, n)) < p_out
    s, d = np.where(np.triu(m, 1))
    keep = labels[s] != labels[d]
    src += list(s[keep]); dst += list(d[keep])
    g = csr_from_edges(n, np.array(src), np.array(dst), symmetrize=True, device=device)
    return g, labels


def features(labels) -> np.ndarray:
    """Node features: a noisy class signal."""
    rng_ = np.random.default_rng(1)
    feats = rng_.normal(0, 1, (len(labels), FEAT_DIM)).astype(np.float32)
    feats[:, :4] += np.eye(4, dtype=np.float32)[labels] * 1.5
    return feats


def norm_adj(g) -> np.ndarray:
    """Symmetric-normalized dense adjacency (small graphs)."""
    n = g.num_vertices
    a = np.zeros((n, n), np.float32)
    ip, ind = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    for v in range(n):
        a[v, ind[ip[v]:ip[v+1]]] = 1.0
    a += np.eye(n, dtype=np.float32)
    d = a.sum(1)
    dinv = 1.0 / np.sqrt(np.maximum(d, 1))
    return a * dinv[:, None] * dinv[None, :]


def init_params(num_classes: int, seed: int = 0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {"w1": torch.randn(FEAT_DIM, HIDDEN, generator=gen) * 0.1,
            "w2": torch.randn(HIDDEN, num_classes, generator=gen) * 0.1}


def gcn_forward(params, adj_norm, x):
    h = torch.relu(adj_norm @ (x @ params["w1"]))
    return adj_norm @ (h @ params["w2"])


def sample_nodes(g, instances: int, r: int, device) -> np.ndarray:
    """Round ``r``'s GraphSAINT minibatch: the union of the vertices that
    MDRW sampled from ``instances`` pools of 8 seeds."""
    kkey = rng.fold_in(rng.PRNGKey(0), r)
    pools = rng.randint(kkey, (instances, 8), 0, g.num_vertices, device=device)
    res = traversal_sample(g, pools, kkey, depth=24,
                           spec=alg.multi_dimensional_random_walk(frontier_size=1),
                           max_degree=g.max_degree(), pool_capacity=16, device=device)
    nodes = torch.unique(torch.cat([res.edges_src.ravel(), res.edges_dst.ravel()])).cpu().numpy()
    return nodes[nodes >= 0]


def train(g, labels, params: dict, *, rounds: int = 40, instances: int = 16,
          device="cuda") -> dict:
    """SGD on the sampled minibatches from ``params`` (``w1``, ``w2``:
    tensors or arrays); prints ``graphsaint_gcn.py``'s lines and returns
    each round's ``nodes`` and ``loss``, the final ``params`` and ``acc``."""
    dev = resolve_device(device)
    g = g.to(dev)
    n = g.num_vertices
    x = torch.from_numpy(features(labels)).to(dev)
    y = torch.from_numpy(labels).to(dev)
    adj = torch.from_numpy(norm_adj(g)).to(dev)
    params = {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
              for k, v in params.items()}

    def accuracy():
        with torch.no_grad():
            return float((gcn_forward(params, adj, x).argmax(-1) == y).float().mean())

    out = {"nodes": [], "loss": []}
    for r in range(rounds):
        nodes = sample_nodes(g, instances, r, dev)
        mask = torch.zeros(n, dtype=torch.float32, device=dev)
        mask[torch.from_numpy(nodes).to(dev)] = 1.0
        p = {k: v.requires_grad_(True) for k, v in params.items()}
        ce = -torch.log_softmax(gcn_forward(p, adj, x), -1)[torch.arange(n, device=dev), y]
        loss = torch.sum(ce * mask) / torch.clamp(mask.sum(), min=1)
        grads = torch.autograd.grad(loss, list(p.values()))
        params = {k: (v - LR * gr).detach() for (k, v), gr in zip(p.items(), grads)}
        out["nodes"].append(nodes)
        out["loss"].append(float(loss.detach()))
        if r % 10 == 0:
            print(f"round {r:3d} sampled_nodes={len(nodes):4d} loss={out['loss'][-1]:.3f} "
                  f"acc={accuracy():.3f}")
    out["acc"] = accuracy()
    out["params"] = params
    print(f"final full-graph accuracy: {out['acc']:.3f}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--instances", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    g, labels = sbm_graph(device=args.device)
    k = int(labels.max() + 1)
    print(f"SBM graph: V={g.num_vertices} E={g.num_edges} classes={k}")
    res = train(g, labels, init_params(k), rounds=args.rounds, instances=args.instances,
                device=args.device)
    if res["acc"] <= 0.6:
        raise SystemExit("GCN failed to learn from sampled subgraphs")


if __name__ == "__main__":
    main()
