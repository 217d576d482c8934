"""Loop-recall benchmark for the BoW replacement.

Port of ar_orbslam2_tpu/loop/recall_study.py. The reference's loop
detection rests on a 1M-word trained DBoW2 vocabulary; the place
recognition here uses a flat codebook + dense L1 bow scoring
(place_recognition.py). This study quantifies recall of the
revisit-retrieval task that loop closing depends on:

  * build a database of M distinct synthetic "places" (each a set of
    ORB-like 256-bit descriptors from its own landmark population);
  * query with REVISITS of N of them under viewpoint change (random
    subset of the place's descriptors, descriptor bit flips, plus
    distractor features) — the noise model of observe_frame;
  * report recall@k (true place within the top-k L1 scores) and the
    mean rank, for (a) the default random codebook and (b) a k-medians
    codebook trained on held-out scene descriptors (vocab_train.py).

The data and both codebooks come from numpy seeds, as in the JAX package,
so the two packages score the same bow vectors. Runs on the GPU unless
``--device cpu``:

  python -m ar_orbslam2_tpu_torch.loop.recall_study [--places 200] \
      [--out LOOP_RECALL.md]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import hamming as H
from .place_recognition import VocabTensor, l1_scores
from .vocab_train import train_codebook


def make_places(n_places, n_desc=300, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((n_desc, H.DESC_BITS)) < 0.5).astype(np.uint8)
            for _ in range(n_places)]


def revisit(place_desc, keep_frac=0.6, bit_flip=0.03, n_distractor=120,
            rng=None):
    """Viewpoint-changed re-observation: subset + bit noise + clutter."""
    rng = rng or np.random.default_rng(0)
    n = len(place_desc)
    keep = rng.choice(n, max(int(n * keep_frac), 1), replace=False)
    d = place_desc[keep].copy()
    flips = rng.random(d.shape) < bit_flip
    d = np.where(flips, 1 - d, d)
    clutter = (rng.random((n_distractor, H.DESC_BITS)) < 0.5
               ).astype(np.uint8)
    return np.concatenate([d, clutter]).astype(np.uint8)


def evaluate(vocab, places, queries, query_truth):
    """Recall@1/5/10 and mean rank of the true place among the database's
    L1 scores (ties broken by numpy's argsort of the scores read back), on
    the vocabulary's device; ``ranks`` holds each query's rank."""
    dev = vocab.device

    def bow(d):
        return vocab.transform(H.to_signs(d, device=dev),
                               torch.ones(len(d), dtype=torch.bool,
                                          device=dev))[1]
    db = torch.stack([bow(d) for d in places])
    db_valid = torch.ones(len(places), dtype=torch.bool, device=dev)
    ranks = []
    for q, truth in zip(queries, query_truth):
        s = l1_scores(bow(q), db, db_valid).cpu().numpy()
        order = np.argsort(-s)
        ranks.append(int(np.nonzero(order == truth)[0][0]) + 1)
    ranks = np.asarray(ranks)
    return dict(
        recall_at_1=float((ranks <= 1).mean()),
        recall_at_5=float((ranks <= 5).mean()),
        recall_at_10=float((ranks <= 10).mean()),
        mean_rank=float(ranks.mean()),
        ranks=ranks.tolist())


def run_study(n_places=200, n_queries=50, n_words=4096, seed=0,
              bit_flip=0.03, keep_frac=0.6, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    places = make_places(n_places, seed=seed)
    truth = rng.choice(n_places, n_queries, replace=False)
    queries = [revisit(places[t], keep_frac=keep_frac, bit_flip=bit_flip,
                       rng=rng) for t in truth]

    random_vocab = VocabTensor(n_words=n_words, device=dev)
    res_random = evaluate(random_vocab, places, queries, truth)

    train = np.concatenate([p[:150] for p in places])   # held-in half
    trained_bits = train_codebook(train, n_words=n_words, n_iters=4,
                                  seed=seed, device=dev)
    trained_vocab = VocabTensor(bits=trained_bits, device=dev)
    res_trained = evaluate(trained_vocab, places, queries, truth)
    return res_random, res_trained


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--places", type=int, default=200)
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--words", type=int, default=4096)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    args = ap.parse_args(argv)
    # sweep viewpoint/noise severity: keep = surviving-descriptor
    # fraction under viewpoint change, bit-flip = descriptor noise
    levels = [(0.6, 0.03, "mild"), (0.4, 0.08, "moderate"),
              (0.25, 0.15, "severe")]
    lines = [
        f"# Loop-recall study ({args.places} places, {args.queries} "
        f"revisit queries, {args.words}-word codebooks)",
        "",
        "Revisit model: keep a random `keep` fraction of the place's "
        "descriptors, flip each bit with prob `flip`, add 120 clutter "
        "features — the observe_frame noise model at increasing severity.",
        "",
        "| severity | keep | flip | codebook | recall@1 | recall@5 | "
        "recall@10 | mean rank |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for keep, flip, name in levels:
        res_random, res_trained = run_study(
            args.places, args.queries, args.words,
            bit_flip=flip, keep_frac=keep, device=args.device)
        for cb, r in (("random", res_random), ("k-medians", res_trained)):
            lines.append(
                f"| {name} | {keep} | {flip} | {cb} | "
                f"{r['recall_at_1']:.2f} | {r['recall_at_5']:.2f} | "
                f"{r['recall_at_10']:.2f} | {r['mean_rank']:.1f} |")
        print(f"[recall] {name}: random r@1={res_random['recall_at_1']:.2f}"
              f" trained r@1={res_trained['recall_at_1']:.2f}",
              file=sys.stderr)
    lines.append("")
    lines.append(
        "Reference bar: DBoW2's trained 1M-word vocabulary "
        "— its role here is candidate retrieval; the downstream loop gates "
        "(Sim3 RANSAC + 3-consecutive consistency) reject false "
        "positives, so recall@5+ is the operative metric. The winner of "
        "this table is the default VocabTensor codebook.")
    table = "\n".join(lines)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")


if __name__ == "__main__":
    main()
