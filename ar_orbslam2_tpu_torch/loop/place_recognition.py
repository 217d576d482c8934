"""Place recognition — bag-of-binary-words as dense device ops.

Port of ar_orbslam2_tpu/loop/place_recognition.py (the replacement for
DBoW2 + KeyFrameDatabase): assigning a frame's descriptors to a W-word
vocabulary is ONE Hamming matmul + argmin, so there is no vocabulary tree.
A frame becomes a tf-normalized word histogram ("BowVector"); similarity is
the DBoW2 L1 score s(a,b) = 1 - 0.5*|a - b|_1 = sum(min(a_i, b_i)) for
L1-normalized vectors, evaluated against ALL keyframes at once. None of it
was a hand kernel in the JAX package (plain XLA), so it is plain torch here:
``torch.matmul`` (float32, TF32 off: the ±1 dot products are exact),
``argmin`` (first index among equals, as ``jnp.argmin``) and ``index_add_``.

The startup vocabulary is a fixed random binary codebook, the same bits as
the JAX package's (``np.random.default_rng(42)``); once the map holds
enough keyframes, ``maybe_retrain`` trains a k-medians codebook from the
map's own descriptors (loop/vocab_train.py) and re-encodes the database.

Candidate selection mirrors KeyFrameDatabase (src/KeyFrameDatabase.cc):
loop candidates must beat the min covisible score and survive
covisibility-group accumulation with a 0.75*best cut; relocalization
candidates skip the minScore gate.

The (max_keyframes, W) float32 bow matrix lives on the device (16 MB at
1024 keyframes x 4096 words) and ``add`` updates one row IN PLACE, where
the JAX package replaces the array. The mapping worker adds on its own CUDA
stream while the tracking thread scores, so both run under one lock: the
writer records an event after its row copy and the reader's stream waits
for it; the reader reads its scores back (a synchronisation) before it
lets go of the lock, so no later write can overtake a read in flight. A
retraining builds the new codebook and the re-encoded matrix aside and
swaps them in under the same lock, so a reader sees the old database or
the new one, never a half-rewritten one.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import hamming as H


def _transform(desc_signs, valid, vocab_f32):
    """(N, 256) ±1 signs -> (word ids (N,) int32, tf bow (W,) float32)."""
    dot = desc_signs.to(torch.float32) @ vocab_f32.T
    dist = (H.DESC_BITS - dot.to(torch.int32)) >> 1
    words = torch.argmin(dist, dim=1)
    bow = torch.zeros(vocab_f32.shape[0], dtype=torch.float32,
                      device=desc_signs.device)
    bow.index_add_(0, words, valid.to(torch.float32))
    bow = bow / torch.clamp(bow.sum(), min=1e-9)
    return words.to(torch.int32), bow


def l1_scores(bow_query, bow_db, db_valid):
    """DBoW2 L1 score of a query against every DB row: (K,) in [0, 1],
    -1 for rows that are not in the database."""
    s = torch.minimum(bow_query[None, :], bow_db).sum(-1)
    return torch.where(db_valid, s, torch.full_like(s, -1.0))


class VocabTensor:
    """Binary vocabulary evaluated as one Hamming matmul. The startup
    codebook is random (it quantizes descriptor space uniformly: no asset,
    no startup cost); other bits can be passed via `bits`."""

    def __init__(self, n_words: int = 4096, seed: int = 42, bits=None,
                 device=None):
        if bits is None:
            rng = np.random.default_rng(seed)
            bits = (rng.random((n_words, H.DESC_BITS)) < 0.5
                    ).astype(np.uint8)
        else:
            bits = np.asarray(bits, np.uint8)
            n_words = bits.shape[0]
        self.n_words = n_words
        self.bits = bits
        self.device = resolve_device(device)
        self.signs = H.to_signs(bits, device=self.device)
        self._signs_f32 = self.signs.to(torch.float32)

    def transform(self, desc_signs, valid):
        """Descriptors -> (word ids (N,), tf bow vector (W,) L1-normed).
        Parity: TemplatedVocabulary::transform producing BowVector (the
        word ids double as the FeatureVector node ids)."""
        return _transform(desc_signs, valid, self._signs_f32)


class KeyFrameDatabase:
    """Inverted-index replacement: dense [MAX_KF, W] bow matrix + masks."""

    def __init__(self, store, vocab: VocabTensor | None = None, device=None):
        self.store = store
        self.device = resolve_device(
            vocab.device if vocab is not None and device is None else device)
        self.vocab = vocab or VocabTensor(device=self.device)
        K = store.cfg.max_keyframes
        self.bow = np.zeros((K, self.vocab.n_words), np.float32)
        self.has_bow = np.zeros(K, bool)
        self.trained = vocab is not None   # custom vocab: NEVER retrain
        self._trained_at = float("inf") if vocab is not None else 0
        # device-resident bow matrix; add() updates one row in place
        self._bow_dev = torch.zeros((K, self.vocab.n_words),
                                    dtype=torch.float32, device=self.device)
        self._lock = threading.Lock()
        self._written = None            # event after the last row write
        # a keyframe slot taken again must not score with the bow vector
        # of the keyframe it held before (mapstore/map.py)
        store.slot_listeners.append(self.forget)

    def _mark_written(self):
        """Record the event the readers' streams wait for (lock held)."""
        if self.device.type == "cuda":
            self._written = torch.cuda.Event()
            self._written.record()

    def reset(self):
        """Empty the database in place, keeping its codebook: the JAX
        package's LoopCloser.reset builds a new database around the old
        vocabulary instead, which leaves the relocalizer on the old object
        (ROADMAP.md §3). As there, the kept codebook is never retrained."""
        with self._lock:
            self.bow[...] = 0.0
            self.has_bow[...] = False
            self._bow_dev.zero_()
            self.trained = True
            self._trained_at = float("inf")
            self._mark_written()

    def maybe_retrain(self, min_kfs: int = 24, max_train: int = 30_000,
                      n_iters: int = 4):
        """K-medians codebook training from the map's own descriptors
        (LOOP_RECALL.md: the trained codebook dominates under severe
        viewpoint change), then every stored bow vector is re-encoded.
        First fires at min_kfs keyframes, then again whenever the map has
        QUADRUPLED since the last training."""
        s = self.store
        n_kf = s.n_keyframes()
        if n_kf < min_kfs:
            return False
        if self.trained and n_kf < 4 * max(self._trained_at, 1):
            return False
        kfs = np.nonzero(self.has_bow & s.kf_valid)[0]
        descs = s.kf_desc[kfs][s.kf_kp_valid[kfs]]
        if len(descs) > max_train:
            rng = np.random.default_rng(0)
            descs = descs[rng.choice(len(descs), max_train, replace=False)]
        from .vocab_train import train_codebook
        bits = train_codebook(H.unpack_bits(descs).reshape(-1, H.DESC_BITS),
                              n_words=self.vocab.n_words, n_iters=n_iters,
                              device=self.device)
        vocab = VocabTensor(bits=bits, device=self.device)
        # re-encode aside, then swap everything in under the lock
        bow = self.bow.copy()         # rows of culled keyframes stay
        bow_dev = self._bow_dev.clone()
        for kf in kfs:
            row = self._encode(vocab, int(kf))
            bow_dev[kf].copy_(row)
        bow[kfs] = bow_dev[torch.as_tensor(kfs, device=self.device)
                           ].cpu().numpy()
        with self._lock:
            self.vocab = vocab
            self.bow = bow
            self._bow_dev = bow_dev
            self.trained = True
            self._trained_at = n_kf
            self._mark_written()
        return True

    def _encode(self, vocab, kf):
        """A stored keyframe's bow row under `vocab`, on the device."""
        s = self.store
        packed = torch.as_tensor(np.ascontiguousarray(s.kf_desc[kf]),
                                 device=self.device)
        valid = torch.as_tensor(np.ascontiguousarray(s.kf_kp_valid[kf]),
                                device=self.device)
        return vocab.transform(H.signs_from_packed(packed), valid)[1]

    def compute_bow(self, desc_bits, valid):
        """Host descriptor bits -> (words, bow) as numpy."""
        signs = H.to_signs(desc_bits, device=self.device)
        valid = torch.as_tensor(np.asarray(valid), device=self.device)
        words, bow = self.vocab.transform(signs, valid)
        return words.cpu().numpy(), bow.cpu().numpy()

    def forget(self, kf: int):
        """Drop slot kf's row (its keyframe was erased and the slot is
        being reused); the new keyframe's row comes with its add()."""
        with self._lock:
            self.bow[kf] = 0.0
            self.has_bow[kf] = False
            self._bow_dev[kf].zero_()
            self._mark_written()

    def add(self, kf: int, bow=None):
        """Parity: KeyFrameDatabase::add."""
        if bow is None:
            row = self._encode(self.vocab, kf)
            bow = row.cpu().numpy()
        else:
            bow = np.asarray(bow, np.float32)
            row = torch.as_tensor(bow, device=self.device)
        with self._lock:
            self.bow[kf] = bow
            self.has_bow[kf] = True
            self._bow_dev[kf].copy_(row)
            self._mark_written()

    def load(self, bow, has_bow):
        """Bulk rewrite of the database (a map carried across)."""
        with self._lock:
            self.bow[...] = bow
            self.has_bow[...] = has_bow
            self._bow_dev.copy_(torch.as_tensor(self.bow))
            self._mark_written()

    def _scores(self, bow_query, exclude=()):
        s = self.store
        query = torch.as_tensor(np.asarray(bow_query, np.float32),
                                device=self.device)
        with self._lock:
            db_valid = self.has_bow & s.kf_valid
            for e in exclude:
                if e >= 0:
                    db_valid = db_valid.copy()
                    db_valid[e] = False
            if self._written is not None:
                torch.cuda.current_stream(self.device).wait_event(
                    self._written)
            scores = l1_scores(query, self._bow_dev,
                               torch.as_tensor(db_valid, device=self.device))
            return scores.cpu().numpy()     # read back before unlocking

    def _group_accumulate(self, scores, min_score):
        """Covisibility-group score accumulation + 0.75*best cut.
        Parity: the accScore loop in DetectLoop/RelocalizationCandidates."""
        s = self.store
        cand = np.nonzero(scores > min_score)[0]
        if len(cand) == 0:
            return []
        acc_best_kf = {}
        acc_scores = {}
        for k in cand:
            group = [int(k)] + [int(g) for g in
                                s.covisible_keyframes(int(k), n_best=10)]
            acc = float(sum(max(scores[g], 0.0) for g in group))
            best_in_group = max(group, key=lambda g: scores[g])
            acc_scores[int(k)] = acc
            acc_best_kf[int(k)] = int(best_in_group)
        best_acc = max(acc_scores.values())
        keep, out = set(), []
        for k, acc in sorted(acc_scores.items(), key=lambda kv: -kv[1]):
            if acc < 0.75 * best_acc:
                continue
            b = acc_best_kf[k]
            if b not in keep:
                keep.add(b)
                out.append(b)
        return out

    def detect_loop_candidates(self, kf: int, bow=None):
        """Parity: KeyFrameDatabase::DetectLoopCandidates — exclude the
        covisible neighborhood, gate at the min covisible score."""
        s = self.store
        if bow is None:
            bow = self.bow[kf]
        connected = [int(k) for k in s.covisible_keyframes(kf)]
        scores = self._scores(bow, exclude=[kf])
        covis_scores = [float(scores[c]) for c in connected
                        if self.has_bow[c]]
        min_score = max(min(covis_scores, default=0.0), 0.0)
        for c in connected:
            scores[c] = -1.0
        return self._group_accumulate(scores, min_score)

    def detect_relocalization_candidates(self, bow):
        """Parity: KeyFrameDatabase::DetectRelocalizationCandidates —
        same accumulation, no minScore gate."""
        scores = self._scores(bow)
        if (scores > 0).sum() == 0:
            return []
        # ref gates at 0.8 * best common-words; tf-score analog: 0.8 * max
        th = 0.8 * float(scores.max())
        return self._group_accumulate(scores, max(th, 0.0))
