"""Map checkpoint / resume — save and restore the whole MapStore.

The reference CANNOT save or load its map (SURVEY.md §5.4: no
checkpointing at all, only trajectory export at shutdown); this fills that
gap deliberately. The SoA layout makes it trivial: every array goes into
one compressed npz; the free-list and graph auxiliaries are reconstructed.
Localization-only mode against a loaded map matches
System::ActivateLocalizationMode semantics with persistence added.
"""
from __future__ import annotations

import json

import numpy as np

from .map import MapConfig, MapStore

_ARRAYS = [
    "kf_valid", "kf_R", "kf_t", "kf_timestamp", "kf_frame_id", "kf_uv",
    "kf_desc", "kf_octave", "kf_angle", "kf_uvr", "kf_depth",
    "kf_kp_valid", "kf_mp", "covis", "kf_parent",
    "mp_valid", "mp_pos", "mp_normal", "mp_dmin", "mp_dmax", "mp_desc",
    "mp_obs_kf", "mp_obs_feat", "mp_nobs", "mp_visible", "mp_found",
    "mp_first_kf",
]


def save_map(store: MapStore, path: str):
    cfg = store.cfg
    meta = dict(max_keyframes=cfg.max_keyframes,
                max_map_points=cfg.max_map_points, max_kp=cfg.max_kp,
                max_obs=cfg.max_obs, covis_threshold=cfg.covis_threshold,
                next_kf=store.next_kf,
                loop_edges={str(k): sorted(int(x) for x in v)
                            for k, v in store.kf_loop_edges.items()})
    arrays = {name: getattr(store, name) for name in _ARRAYS}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_map(path: str) -> MapStore:
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    cfg = MapConfig(max_keyframes=meta["max_keyframes"],
                    max_map_points=meta["max_map_points"],
                    max_kp=meta["max_kp"], max_obs=meta["max_obs"],
                    covis_threshold=meta["covis_threshold"])
    store = MapStore(cfg)
    for name in _ARRAYS:
        getattr(store, name)[...] = data[name]
    store.next_kf = int(meta["next_kf"])
    store.kf_loop_edges = {int(k): set(v)
                           for k, v in meta["loop_edges"].items()}
    store.mp_free = [int(i) for i in
                     np.nonzero(~store.mp_valid)[0][::-1]]
    return store
