"""The detection gates of ``scripts/validate_scene_matrix.py`` (numpy
only to import): the port's scene-matrix phase in ``chip_smoke.py`` and
its CPU test share them; ``python tests/scene_gates.py cpu`` (or
``cuda``) runs the port's matrix and prints one line a scene. That script imports the JAX package, which neither the
port nor ``chip_smoke.py`` may, so its gates are repeated here.

``scene_gates(name, m)`` holds one scene's ``evaluate_planar_sequence(...,
details=True)`` metrics to:

- no phantom and no ego-motion failure;
- D1 < 0.05;
- each object hit in at least 0.8 of the frames where it is scoreable, or
  0.5 in ``occlusion`` (one object hides the other while they cross);
- in ``approach``, at least 2 of the last 3 frames with a scoreable
  object hit (expansion flow crosses the dynamic gate late);
- median velocity error < ``VEL_GATE`` m/s (the script's gate for v6 and
  later weights) and median centre error < 0.3 m.
"""

VEL_GATE = 0.6  # m/s, scripts/validate_scene_matrix.py:16-17 for v6+
D1_GATE = 0.05
CENTER_GATE = 0.3  # m
HIT_GATE = 0.8
OCCLUSION_HIT_GATE = 0.5
DISPARITY_RATE = 3.0  # px/s, the script's validated operating point
SCENES = ("lateral", "multi_object", "occlusion", "approach",
          "rotating_cam", "sloped_bg")
# The JAX package's record for pwc_v7 at scale 1 (the comment on
# pwc_v7.fp16.npz in its utils/checkpoint.py, lines 116-133): median
# velocity error, m/s, "ALL PASS with ZERO phantoms".
JAX_RECORD_VEL = {"lateral": 0.184, "multi_object": 0.259,
                  "occlusion": 0.309}
# Faults of the reference: the gates the JAX package itself fails at 192 x
# 448, scale 1, disparity rate 3.0, vel gate 0.6, pwc_v7
# (``scripts/validate_scene_matrix.py --scale 1 --vel-gate 0.6
# --disparity-rate 3.0`` on the CPU: approach vel_err 1.255, rotating_cam
# 12 phantoms; the other four pass). There the port must fail the same
# gates and no other.
JAX_FAILS = {"approach": {"vel_err_median"}, "rotating_cam": {"phantoms"}}


def hit_fractions(m, n_objects: int) -> list:
    """Each object's hits over the frames where it was scoreable (None
    where it never was)."""
    hits = [0] * n_objects
    scoreable = [0] * n_objects
    for df in m["detail_frames"]:
        for sc, hit in zip(df["scoreable"], df["matched"]):
            j = sc["obj_index"]
            scoreable[j] += 1
            hits[j] += int(hit)
    return [hits[j] / scoreable[j] if scoreable[j] else None
            for j in range(n_objects)]


def scene_gates(name: str, m, n_objects: int,
                vel_gate: float = VEL_GATE) -> list:
    """(gate, value, limit, passed) for every gate of the scene."""
    gates = [
        ("phantoms", m["phantoms"], "== 0", m["phantoms"] == 0),
        ("ego_failures", m["ego_failures"], "== 0", m["ego_failures"] == 0),
        ("d1", m["d1"], f"< {D1_GATE}", m["d1"] < D1_GATE),
    ]
    if name == "approach":
        appr = [df["matched"][0] for df in m["detail_frames"]
                if df["matched"]]
        gates.append(("approach_hits_of_last_3", sum(appr[-3:]), ">= 2",
                      sum(appr[-3:]) >= 2))
    else:
        floor = OCCLUSION_HIT_GATE if name == "occlusion" else HIT_GATE
        for j, f in enumerate(hit_fractions(m, n_objects)):
            gates.append((f"obj{j}_hit", f, f">= {floor}",
                          f is None or f >= floor))
    gates += [
        ("vel_err_median", m["vel_err_median"], f"< {vel_gate}",
         m["vel_err_median"] < vel_gate),
        ("center_err_median", m["center_err_median"], f"< {CENTER_GATE}",
         m["center_err_median"] < CENTER_GATE),
    ]
    return gates


def matrix_verdict(name: str, gates) -> list:
    """What fails the phase for one scene's ``scene_gates``: every failed
    gate, or for a scene in JAX_FAILS any difference from the JAX
    package's outcome (a gate it passes that the port fails, or the
    reverse)."""
    failed = {g for g, _, _, ok in gates if not ok}
    want = JAX_FAILS.get(name, set())
    return ([f"{g} fails (the JAX package passes it)"
             for g in sorted(failed - want)]
            + [f"{g} passes (the JAX package fails it)"
               for g in sorted(want - failed)])


if __name__ == "__main__":
    # The port's scene matrix on one device: python tests/scene_gates.py
    # [cpu|cuda]. One line a scene, as scripts/validate_scene_matrix.py
    # prints the JAX package's.
    import os
    import sys

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from moving_object_detector_tpu_torch.config import FlowNetConfig
    from moving_object_detector_tpu_torch.eval import (
        evaluate_planar_sequence,
    )
    from moving_object_detector_tpu_torch.io.scenes import validation_scenes
    from moving_object_detector_tpu_torch.utils.checkpoint import (
        default_flow_checkpoint,
        load_flow_checkpoint,
    )

    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    model, _ = load_flow_checkpoint(default_flow_checkpoint(),
                                    FlowNetConfig(), device=dev)
    for name, seq in validation_scenes(h=192, w=448, fx=300.0).items():
        m = evaluate_planar_sequence(seq, model,
                                     dynamic_disparity_rate=DISPARITY_RATE,
                                     details=True, device=dev)
        gates = scene_gates(name, m, len(seq.objects))
        bad = [f"{g}={v:.3f}" for g, v, _, ok in gates if not ok]
        hits = ",".join("-" if f is None else f"{f:.2f}"
                        for f in hit_fractions(m, len(seq.objects)))
        print(f"{name:13s} {'FAIL(' + ','.join(bad) + ')' if bad else 'PASS':40s}"
              f" d1={m['d1']:.3f} epe={m['flow_epe']:.2f} "
              f"ego={m['ego_rot_err_deg']:.2f}deg hits=[{hits}] "
              f"phantoms={m['phantoms']} vel={m['vel_err_median']:.3f} "
              f"ctr={m['center_err_median']:.3f} verdict="
              f"{matrix_verdict(name, gates) or 'as the JAX package'}",
              flush=True)
