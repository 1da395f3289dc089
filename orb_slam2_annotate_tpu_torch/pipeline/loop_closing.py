"""Loop detection's database half (port of pipeline/loop_closing.py).

``detect_loop_device`` runs on every keyframe: it writes the keyframe's BoW
row into the database (which relocalization reads) and retrieves loop
candidates.  The host half (consistency streaks, ``resolve_detection``),
the Sim3 computation, loop correction and global BA are not ported yet:
``enable_loop_closing=True`` raises in ``System``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..geometry.camera import CameraModel
from ..ops.orb import DESC_WORDS
from ..worldmap import map_state as ms
from ..worldmap import vocabulary as voc

# the trained 16384-word vocabulary (a byte-identical copy of the reference's
# asset, checked by tests/test_torch_system.py), read by path with numpy
TRAINED_VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "worldmap", "trained_vocab.npz")


@dataclasses.dataclass
class LoopDetectOut:
    db_bows: torch.Tensor     # [K, W] database with the new row written
    cands: torch.Tensor       # [8] candidate slots
    ok: torch.Tensor          # [8] bool
    cand_covis: torch.Tensor  # [8, K] int32 covisibility rows of the candidates


def detect_loop_device(vocab: voc.Vocabulary, db_bows: torch.Tensor, m: ms.MapState, slot: int,
                       gap_kf: int = 10) -> LoopDetectOut:
    """BoW vector of keyframe `slot`, the lowest score among its covisible
    neighbours, and candidates outside its covisible group and the `gap_kf`
    newest keyframes."""
    K = m.K
    bow = voc.bow_vector(vocab, m.kf_desc[slot], m.kf_feat_valid[slot])
    covis_mask = ms.covis_row(m, slot) > 0
    covis_mask[slot] = True
    others = covis_mask & m.kf_valid & (torch.arange(K, device=m.device) != slot)
    scores = voc.l1_scores(db_bows, bow)
    min_score = torch.where(others, scores, float("inf")).min()
    min_score = torch.where(torch.isfinite(min_score), min_score, 0.0)
    fid = torch.where(m.kf_valid, m.kf_frame_id, -1)
    order = torch.argsort(-fid, stable=True)
    recent = torch.zeros(K, dtype=torch.bool, device=m.device)
    recent[order[:gap_kf]] = True
    slots, ok = voc.detect_loop_candidates(voc.KeyFrameDatabase(db_bows), bow, m.kf_valid,
                                           covis_mask | recent, min_score)
    db_new = db_bows.clone()
    db_new[slot] = bow
    return LoopDetectOut(db_new, slots, ok, ms.covis_rows(m, slots, ok).to(torch.int32))


@dataclasses.dataclass
class LoopCloserConfig:
    """The reference's LoopCloserConfig fields with the same defaults."""

    n_words: int = 16384
    consistency_th: int = 3
    min_seed_matches: int = 15
    min_seed_inliers: int = 6
    seed_hyp: int = 1024
    seed_th_chi2: float = 100.0
    verify_th_chi2: float = 100.0
    drift_rot_frac: float = 0.25
    drift_rot_abs: float = 0.12
    drift_trans_frac: float = 0.35
    drift_trans_abs_baselines: float = 2.0
    drift_log_scale_max: float = 0.5
    min_ransac_inliers: int = 12
    min_total_matches: int = 25
    max_sim3_candidates: int = 5
    fix_scale: bool = False
    pose_graph_iters: int = 15
    gap_kf: int = 3
    cooldown_kf: int = 10
    run_global_ba: bool = True
    global_ba_iters: int = 10
    use_dist_gba: bool = True


class LoopCloser:
    """The vocabulary and keyframe database, kept up to date on every keyframe."""

    def __init__(self, cam: CameraModel, max_kf: int, config: LoopCloserConfig | None = None,
                 seed: int = 42, device="cuda"):
        self.cam = cam
        self.cfg = config or LoopCloserConfig()
        self.device = torch.device(device)
        self.vocab = self._default_vocabulary(seed)
        self.db = voc.KeyFrameDatabase.create(max_kf, self.cfg.n_words, device=self.device)

    def _default_vocabulary(self, seed: int) -> voc.Vocabulary:
        """The trained vocabulary when it has the configured size, else a
        seeded random one (the reference's rule)."""
        if os.path.exists(TRAINED_VOCAB):
            v = voc.load_vocabulary(TRAINED_VOCAB, device=self.device)
            if v.n_words == self.cfg.n_words and v.words.shape[-1] == DESC_WORDS:
                return v
        return voc.make_vocabulary(self.cfg.n_words, seed, device=self.device)

    def grow_db(self, new_max_kf: int):
        """Grow the database's keyframe axis with the map's capacity."""
        K, W = self.db.bows.shape
        if new_max_kf > K:
            pad = torch.zeros((new_max_kf - K, W), dtype=torch.float32, device=self.device)
            self.db = voc.KeyFrameDatabase(torch.cat([self.db.bows, pad]))

    def dispatch_detection(self, m: ms.MapState, slot: int) -> LoopDetectOut:
        """Run detection for keyframe `slot` and adopt the updated database."""
        out = detect_loop_device(self.vocab, self.db.bows, m, slot, self.cfg.gap_kf)
        self.db = voc.KeyFrameDatabase(out.db_bows)
        return out
