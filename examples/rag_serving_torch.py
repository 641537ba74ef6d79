"""RAG-style serving with the PyTorch port: LM embeddings → SQUASH hybrid
retrieval → generation.

    PYTHONPATH=src python examples/rag_serving_torch.py [--device cpu]

The twin of ``examples/rag_serving.py`` (DESIGN.md §5.i–ii): a small
decoder LM (phi4-mini reduced: vocab 1,024, d_model 128, 2 layers) embeds
512 documents of 24 tokens by its mean-pooled final hidden state; SQUASH
indexes the embeddings with 4 attributes; 4 queries (documents plus noise)
retrieve their filtered neighbours through ``search(backend="torch")``
(kernel 1 and a Stage 4 kernel on the card); the LM then generates
continuations of prompts built from the retrieved documents through the
serving engine, once with the float KV cache and once with the OSQ-packed
8-bit cache, whose greedy tokens must agree on at least 75 % (the paper's
quantization applied to the serving substrate). Runs on the CUDA card
unless ``--device cpu``; raises without CUDA.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.attributes import Predicate
from repro_torch.core.pipeline import SquashConfig, SquashIndex
from repro_torch.models import transformer as T
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import resolve_device

N_DOCS, DOC_LEN, K = 512, 24, 5
GEN_LEN = 24
N_QUERIES = 4
PREDICATES = [Predicate(attr=0, op="<", lo=8), Predicate(attr=1, op=">=", lo=4)]


@torch.no_grad()
def embed_documents(model, tokens: torch.Tensor,
                    batch: int = 256) -> np.ndarray:
    """Mean-pooled final hidden state (pre-logits) of each row of
    ``tokens`` as its float32 embedding, ``batch`` rows at a time."""
    out = []
    for start in range(0, tokens.shape[0], batch):
        x = model.embed(tokens[start:start + batch])
        b, s = x.shape[:2]
        positions = T.make_positions(b, s, x.device)
        for blk in model.blocks:
            x, _ = blk.block_train(x, positions)
        x = model.final_norm(x)
        out.append(x.mean(dim=1).to(torch.float32).cpu().numpy())
    return np.concatenate(out)


def build(embs: np.ndarray, rng) -> SquashIndex:
    """The example's index: the embeddings with 4 attributes of
    cardinality 16."""
    attrs = rng.integers(0, 16, (embs.shape[0], 4)).astype(np.float64)
    return SquashIndex.build(embs, attrs, SquashConfig(
        num_partitions=4, min_hamming_keep=32))


def queries_for(embs: np.ndarray, rng) -> np.ndarray:
    """The first documents' embeddings plus a little noise."""
    return embs[:N_QUERIES] + rng.normal(
        0, 0.01, (N_QUERIES, embs.shape[1])).astype(np.float32)


def prompts_for(docs: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Each query's prompt: the first 8 tokens of its two nearest
    documents."""
    return np.stack([np.concatenate([docs[i][:8] for i in row[:2]])
                     for row in ids])


def generate(cfg, model, prompts: np.ndarray, device, kv_bits: int = 0):
    """Greedy continuations of ``prompts`` and the engine (its cache
    bytes and timing)."""
    eng = Engine(cfg, model, ServeConfig(max_new_tokens=GEN_LEN,
                                         kv_bits=kv_bits), device=device)
    return eng.generate(prompts), eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("phi4-mini-3.8b").reduced(vocab_size=1024, d_model=128,
                                               num_layers=2)
    model = T.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)

    print(f"embedding {N_DOCS} documents with the LM on {dev}...")
    docs = rng.integers(0, cfg.vocab_size, (N_DOCS, DOC_LEN), dtype=np.int32)
    embs = embed_documents(model, torch.from_numpy(docs).to(dev))

    print("indexing embeddings + attributes with SQUASH...")
    idx = build(embs, rng)

    print("hybrid retrieval (category < 8, freshness >= 4)...")
    ids, _, _ = idx.search(queries_for(embs, rng), PREDICATES, k=K,
                           backend="torch", device=dev)
    print(f"  retrieved ids: {ids[:, :3].tolist()}")

    print("generating with retrieved context (batched serving)...")
    prompts = prompts_for(docs, ids)
    out, _ = generate(cfg, model, prompts, dev)
    print(f"  generated {out.shape} tokens")

    # OSQ-quantized KV: same outputs at 4x less cache traffic.
    out_q, eng_q = generate(cfg, model, prompts, dev, kv_bits=8)
    sizes = eng_q.last_cache_bytes
    agree = float((out == out_q).mean())
    print(f"  OSQ-KV(8-bit): cache {sizes['fp'] / sizes['packed']:.1f}x "
          f"smaller, token agreement {agree:.0%}")
    assert agree >= 0.75


if __name__ == "__main__":
    main()
