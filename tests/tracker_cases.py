"""Detection sequences for the tracker tests, numpy only (the CPU tests
against the JAX package and the plain reference, and the card's graph
tests share them).

A case is a list of frames ``(t, center, velocity, bbox, valid,
frame_valid)``: arrays of ``n_obs`` detection slots in the odom frame and
the frame's flag. ``CASES`` names each with the track capacity it runs
at; ``serving`` is the benchmark's 64 tracks x 16 detections.
"""

import numpy as np

def _frame(t, n_obs, dets, frame_valid=True, rng=None):
    """A frame from ``dets``, a list of (slot, (x, y), (vx, vy)); box
    sizes drawn from ``rng`` (or fixed)."""
    center = np.zeros((n_obs, 3), np.float32)
    velocity = np.zeros((n_obs, 3), np.float32)
    valid = np.zeros((n_obs,), bool)
    for slot, p, v in dets:
        center[slot] = [p[0], p[1], 5.0 + slot]
        velocity[slot] = [v[0], v[1], 0.0]
        valid[slot] = True
    bbox = (np.abs(rng.normal(1.0, 0.1, (n_obs, 3))) if rng is not None
            else np.ones((n_obs, 3))).astype(np.float32) * valid[:, None]
    return (np.float32(t), center, velocity, bbox, valid, frame_valid)


def _movers(t, rng, movers, noise=0.02):
    return [(slot, np.add(p0, np.multiply(v, t)) + rng.normal(0, noise, 2),
             v) for slot, p0, v in movers]


def adjacent_spawn(n_obs=6):
    """Two unmatched detections 0.3 m apart spawn in one frame: the first
    spawns, the second is within reach of it and does not; then both move
    on together with a third far away."""
    rng = np.random.default_rng(11)
    frames = []
    for k in range(5):
        t = 0.1 * k
        dets = _movers(t, rng, [(1, (1.0, 2.0), (1.0, 0.0)),
                                (2, (1.3, 2.0), (1.0, 0.0)),
                                (4, (-3.0, 1.0), (0.0, 0.5))], noise=0.01)
        frames.append(_frame(t, n_obs, dets, rng=rng))
    return frames


def slots_full(n_obs=6):
    """Six unmatched detections far apart against 4 track slots: the first
    four spawn and fill the bank, the rest find no slot; later frames keep
    more detections than slots."""
    rng = np.random.default_rng(12)
    frames = []
    for k in range(4):
        t = 0.1 * k
        dets = [(i, (3.0 * i - 7.0 + 0.1 * k, 2.0 * (k % 2)), (1.0, 0.0))
                for i in range(n_obs)]
        frames.append(_frame(t, n_obs, dets, rng=rng))
    return frames


def all_invalid(n_obs=6):
    """Tracks made, then frames whose detections are all invalid: predict
    alone, nothing matched, spawned or published; then the objects again."""
    rng = np.random.default_rng(13)
    movers = [(0, (0.0, 0.0), (1.0, 0.0)), (3, (4.0, -2.0), (0.0, 1.0))]
    frames = []
    for k in range(7):
        t = 0.1 * k
        dets = [] if k in (3, 4) else _movers(t, rng, movers)
        frames.append(_frame(t, n_obs, dets, rng=rng))
    return frames


def pruned(n_obs=6):
    """A track seen twice, then not for a long gap: its covariance trace
    passes the limit and it is pruned, while a second object, seen every
    frame, stays."""
    rng = np.random.default_rng(14)
    frames = []
    for k, t in enumerate((0.0, 0.1, 0.2, 1.2, 2.2, 2.3)):
        movers = [(0, (2.0, 2.0), (0.0, 0.0))]
        if k < 2:
            movers.append((1, (-2.0, -2.0), (0.5, 0.0)))
        frames.append(_frame(t, n_obs, _movers(t, rng, movers), rng=rng))
    return frames


def frame_invalid(n_obs=6):
    """A pair with valid detections but ``frame_valid`` false in the
    middle of a run (the ego-motion failed): the state stays, nothing is
    published; the first pair of a run is one too."""
    rng = np.random.default_rng(15)
    movers = [(0, (1.0, 0.0), (1.0, 0.0)), (2, (-1.0, 3.0), (0.0, -1.0))]
    return [_frame(0.1 * k, n_obs, _movers(0.1 * k, rng, movers),
                   frame_valid=k not in (0, 5), rng=rng)
            for k in range(9)]


def serving(n_obs=16, n_frames=10, seed=16):
    """The benchmark's shapes: 2 to 6 movers a pair at 6 to 18 m, one of
    them leaving and one arriving, clutter that spawns and dies, one pair
    with ``frame_valid`` false."""
    rng = np.random.default_rng(seed)
    movers = [(i, (rng.uniform(-8, 8), rng.uniform(6, 18)),
               (rng.choice([-1, 1]) * rng.uniform(1.3, 3.0), 0.0))
              for i in range(6)]
    frames = []
    for k in range(n_frames):
        t = k / 15.0
        live = [m for i, m in enumerate(movers)
                if not (i == 5 and k < 4) and not (i == 4 and k > 6)]
        dets = _movers(t, rng, live)
        for j in range(int(rng.integers(0, 3))):
            dets.append((8 + j, tuple(rng.uniform(-10, 10, 2)), (0.0, 0.0)))
        frames.append(_frame(t, n_obs, dets, frame_valid=k != 7, rng=rng))
    return frames


# name: (frames, track capacity)
CASES = {
    "adjacent_spawn": (adjacent_spawn, 8),
    "slots_full": (slots_full, 4),
    "all_invalid": (all_invalid, 8),
    "pruned": (pruned, 8),
    "frame_invalid": (frame_invalid, 8),
    "serving": (serving, 64),
}
