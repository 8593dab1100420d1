"""A run with the timed path broken underneath comes out not correct:
the rest of a run (the drivers, the judges, the reference) at a small
size on the CPU, the look for a card skipped, one fault a test: a step
that returns its state unchanged, an answer altered where it is made,
and for training half of the batch left out (the mean over the rest).
The cells run on one card, so there is no exchange between cards to
leave out."""

from __future__ import annotations

import torch

from moving_object_detector_tpu_torch import pipeline
from moving_object_detector_tpu_torch.train import flow_trainer
from portbench.tests import tiny


def _failed(out) -> set:
    return {c["name"] for c in out["checks"] if not c["ok"]}


def test_serving_step_that_keeps_its_state(monkeypatch):
    real = pipeline.detect_step

    def stale(model, state, *args, **kwargs):
        _, out = real(model, state, *args, **kwargs)
        return state, out

    monkeypatch.setattr(pipeline, "detect_step", stale)
    _, out = tiny.run("kitti_s2.max_busy")
    assert "state_differ" in _failed(out)


def test_serving_disparity_altered_where_it_is_made(monkeypatch):
    real = pipeline._sgm_forward

    def shifted(*args, **kwargs):
        d = real(*args, **kwargs)
        return d.replace(disparity=torch.where(
            d.disparity >= 0, d.disparity + 0.5, d.disparity))

    monkeypatch.setattr(pipeline, "_sgm_forward", shifted)
    _, out = tiny.run("kitti_s2.live_busy")
    assert "disparity_px_differ" in _failed(out)


def test_serving_detections_altered_where_they_are_made(monkeypatch):
    real = pipeline.cluster_scene_flow

    def moved(*args, **kwargs):
        objects, labels, overflow = real(*args, **kwargs)
        return objects.replace(valid=~objects.valid), labels, overflow

    monkeypatch.setattr(pipeline, "cluster_scene_flow", moved)
    _, out = tiny.run("kitti_s2.max_quiet")
    assert "detections_differ" in _failed(out)


def test_train_step_that_keeps_its_state(monkeypatch):
    def no_update(state, tx, params, grads):
        state.step += 1

    monkeypatch.setattr(flow_trainer, "_apply", no_update)
    _, out = tiny.run("pwc_train_chairs.b8")
    assert {"grad_norm_gap", "update_norm_gap"} <= _failed(out)
    assert out["numbers"]["update_norm_gap"] > 0.9


def test_train_half_the_batch(monkeypatch):
    real = flow_trainer.flow_loss

    def half(model, img1, img2, flow, **kwargs):
        n = img1.shape[0] // 2
        return real(model, img1[:n], img2[:n], flow[:n], **kwargs)

    monkeypatch.setattr(flow_trainer, "flow_loss", half)
    _, out = tiny.run("pwc_train_chairs.b8")
    assert "loss_gap" in _failed(out)


def test_train_loss_altered_where_it_is_made(monkeypatch):
    real = flow_trainer.flow_loss

    def scaled(*args, **kwargs):
        loss, epe = real(*args, **kwargs)
        return loss * 1.5, epe

    monkeypatch.setattr(flow_trainer, "flow_loss", scaled)
    _, out = tiny.run("pwc_train_chairs.b8")
    assert "loss_gap" in _failed(out)
    assert out["numbers"]["loss_gap"] > 0.4


def test_train_window_step_that_drops_its_update(monkeypatch):
    """Updates lost once the window runs (set-up's chunk is sound): the
    window's stretch alone sees it."""
    real = flow_trainer._apply

    def lost(state, tx, params, grads):
        if state.step < 4:  # set-up's chunk of the shrunk cell
            real(state, tx, params, grads)
        else:
            state.step += 1

    monkeypatch.setattr(flow_trainer, "_apply", lost)
    _, out = tiny.run("pwc_train_chairs.b8")
    failed = _failed(out)
    assert "window_update_norm_gap" in failed
    assert not {"loss_gap", "grad_norm_gap", "update_norm_gap"} & failed


def test_train_window_batches_replayed_from_a_chunk_start(monkeypatch):
    """Each chunk after set-up's draws its batches from the generator as it
    stood at the first chunk's start (a replay that does not move it)."""
    from moving_object_detector_tpu_torch.train import data_synth

    real = data_synth.generate_batch
    seen = {"calls": 0}

    def replayed(gen, *args, **kwargs):
        if seen["calls"] == 0:
            seen["first"] = gen.get_state()
        elif seen["calls"] % 4 == 0:  # a chunk of the shrunk cell starts
            gen.set_state(seen["first"])
        seen["calls"] += 1
        return real(gen, *args, **kwargs)

    monkeypatch.setattr(data_synth, "generate_batch", replayed)
    _, out = tiny.run("pwc_train_chairs.b8")
    failed = _failed(out)
    assert "window_batch_differ" in failed
    assert "batch_differ" not in failed
