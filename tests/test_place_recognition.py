"""O(1) place recognition: global keyframe signatures + shortlist
(loop_closing/signature.py; brute-force detection was
O(#keyframes) per keyframe)."""
import numpy as np
import pytest

from visual_slam_tpu.loop_closing.signature import (
    N_WORDS_VOCAB,
    batch_signatures,
    keyframe_signature,
    score_signatures,
)


def _random_block(rng, K=256, n_valid=200):
    desc = rng.integers(0, 2**32, size=(K, 8), dtype=np.uint32)
    valid = np.zeros(K, bool)
    valid[:n_valid] = True
    return desc, valid


def _perturb(rng, desc, flip_bits=12):
    """Flip a few bits of every descriptor (viewpoint/noise model)."""
    out = desc.copy()
    for _ in range(flip_bits):
        word = rng.integers(0, 8)
        bit = rng.integers(0, 32)
        rows = rng.integers(0, desc.shape[0], size=desc.shape[0] // 4)
        out[rows, word] ^= np.uint32(1 << bit)
    return out


def test_signature_shape_and_norm():
    rng = np.random.default_rng(0)
    desc, valid = _random_block(rng)
    sig = np.asarray(keyframe_signature(desc, valid))
    assert sig.shape == (N_WORDS_VOCAB,)
    assert abs(np.linalg.norm(sig) - 1.0) < 1e-5
    assert (sig >= 0).all()


def test_signature_revisit_ranks_first():
    """A revisited place (same descriptors + bit noise) must out-rank every
    unrelated keyframe — the shortlist recall property the loop detector
    stands on."""
    rng = np.random.default_rng(1)
    scenes = [_random_block(rng) for _ in range(40)]
    sigs = batch_signatures(
        np.stack([d for d, _ in scenes]), np.stack([v for _, v in scenes])
    )
    target = 17
    q_desc = _perturb(rng, scenes[target][0])
    q_sig = np.asarray(keyframe_signature(q_desc, scenes[target][1]))
    scores = score_signatures(q_sig, sigs)
    assert int(np.argmax(scores)) == target, scores[target]
    # ... and with margin: the true match beats the best impostor clearly.
    impostors = np.delete(scores, target)
    assert scores[target] > impostors.max() + 0.2, (scores[target], impostors.max())


def test_shortlist_flat_at_500_keyframes():
    """Endurance: with 500 keyframes in the table, the shortlist keeps the
    geometric-verification candidate set CONSTANT (shortlist_size), and
    still recalls the revisited keyframe. Host-side scoring is a (V,).(V,N)
    matvec — flat per-keyframe cost by construction."""
    rng = np.random.default_rng(2)
    N = 500
    blocks = [_random_block(rng, K=128, n_valid=100) for _ in range(N)]
    sigs = batch_signatures(
        np.stack([d for d, _ in blocks]), np.stack([v for _, v in blocks])
    )
    assert sigs.shape == (N, N_WORDS_VOCAB)
    target = 321
    q = np.asarray(
        keyframe_signature(_perturb(rng, blocks[target][0]), blocks[target][1])
    )
    scores = score_signatures(q, sigs)
    S = 8
    top = np.argsort(-scores)[:S]
    assert len(top) == S
    assert target in top.tolist()


def test_loop_closing_uses_shortlist(monkeypatch):
    """LoopClosing.detect must hand the batched matcher at most
    shortlist_size candidates when signatures are on (the flat-bucket
    property), and still find the true revisit."""
    import jax

    from visual_slam_tpu.camera import PinholeCamera
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.loop_closing import LoopClosing
    from visual_slam_tpu.loop_closing import loop_closing as lc_mod
    from visual_slam_tpu.map import Frame, KeyFrame, Map
    from visual_slam_tpu.ops.detector import Features

    rng = np.random.default_rng(3)
    K = 128
    cfg = Config()
    cfg.loop_closing.enabled = True
    cam = PinholeCamera(width=320, height=240,
                        K=np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]]))
    m = Map()

    def make_kf(desc, valid):
        xy = rng.uniform(20, 200, size=(K, 2)).astype(np.float32)
        feats = Features(
            xy=xy, response=np.ones(K, np.float32),
            angle=np.zeros(K, np.float32), octave=np.zeros(K, np.int32),
            size=np.full(K, 31.0, np.float32), desc=desc, valid=valid,
        )
        kf = KeyFrame.from_frame(Frame(features=[feats]))
        m.add_keyframe(kf)
        return kf

    blocks = [_random_block(rng, K=K, n_valid=K) for _ in range(30)]
    kfs = [make_kf(d, v) for d, v in blocks]
    lc = LoopClosing(m, cam, cfg)

    captured = {}
    orig = lc_mod.match_descriptors_batched

    def spy(q_desc, c_desc, *a, **k):
        captured["n_candidates"] = int(np.asarray(c_desc).shape[0])
        return orig(q_desc, c_desc, *a, **k)

    monkeypatch.setattr(lc_mod, "match_descriptors_batched", spy)
    # Query = noisy revisit of keyframe 3 (outside the recent-window gap).
    q_kf = make_kf(_perturb(rng, blocks[3][0], flip_bits=4), blocks[3][1])
    lc.detect(q_kf)
    assert captured, "batched matcher was not called"
    # Bucketed shortlist: padded to the bucket floor, NOT to the map size.
    assert captured["n_candidates"] <= 64
    # Recall: the true revisit must be in the shortlist handed to verify.
    short = lc._signature_shortlist(
        q_kf, [k for k in m.get_keyframes()[:-11] if k is not q_kf]
    )
    assert kfs[3] in short
