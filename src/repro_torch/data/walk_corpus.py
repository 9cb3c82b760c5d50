"""Walk corpus: the C-SAW engine as the LM data plane (DESIGN.md §4).

DeepWalk/node2vec walks over a graph become token sequences for any of the
decoder architectures (vertex id = token id): the port of
``repro.data.walk_corpus``, on the port's walk engine and counted RNG, so
the corpus equals ``repro``'s bit for bit for the same graph and seed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import algorithms as alg
from repro_torch.core import rng
from repro_torch.core.engine import random_walk
from repro_torch.graph.csr import CSRGraph, resolve_device


def build_walk_corpus(
    graph: CSRGraph,
    *,
    num_walks: int,
    walk_length: int,
    algorithm: str = "deepwalk",
    seed: int = 0,
    max_degree: int | None = None,
    vocab_size: int | None = None,
    device="cuda",
    **algo_kwargs,
) -> np.ndarray:
    """Generate (num_walks, walk_length+1) int32 token sequences via C-SAW,
    walked on ``device`` (``cuda`` unless the caller asks for the CPU).

    Dead-end walks are padded by repeating the last vertex (decoders need
    dense rows); vocab_size asserts vertex ids fit the LM embedding.
    """
    dev = resolve_device(device)
    spec = alg.ALGORITHMS[algorithm](**algo_kwargs)
    key = rng.PRNGKey(seed)
    seeds = rng.randint(rng.fold_in(key, 1), (num_walks,), 0, graph.num_vertices, device=dev)
    md = max_degree or graph.max_degree()
    res = random_walk(graph, seeds, key, depth=walk_length, spec=spec, max_degree=md,
                      device=dev)
    walks = res.walks.cpu().numpy()
    # pad dead ends by forward-filling the last valid vertex (vectorized;
    # column 0 is always a seed, so every row has a fill source)
    col = np.where(walks < 0, 0, np.arange(walks.shape[1]))
    walks = np.take_along_axis(walks, np.maximum.accumulate(col, axis=1), axis=1)
    if vocab_size is not None and walks.max() >= vocab_size:
        raise ValueError(f"graph vertices exceed the LM vocabulary of {vocab_size}")
    return walks.astype(np.int32)
