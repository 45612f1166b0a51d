"""Activation checkpointing in the port's training: ``decoder.remat_heads``
(JAX ``nn.remat`` of the prediction heads) on the tiny R50 training
config, for each task, and ``backbone.swin_use_checkpoint`` (JAX
``nn.remat(SwinBlock)``) on the small Swin of ``test_torch_backbones``
(window 3, every stage map padded), both with ``remat_heads``: one train
step with checkpointing logs the same losses bit for bit as the step
without it, and its working gradients are within 1e-6 of each gradient's
scale.  The regions are checkpointed (their ``checkpoint`` calls
counted), and a step's draws are addressed, so the recompute takes the
same draws."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_train_util import tiny_train_arrays, torch_batch, train_cfgs
from univs_tpu_torch.models import decoder as decoder_mod
from univs_tpu_torch.models.backbones import swin
from univs_tpu_torch.models.univs import build_model
from univs_tpu_torch.parallel import train_state as tts
from univs_tpu_torch.utils.draws import make_key

torch.set_num_threads(1)

SWIN_SMALL = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4))


def _step(cfg, task, arrays):
    """(logged losses, working gradients by name) of one train step."""
    model = build_model(cfg, None, seed=4, device="cpu")
    state = tts.create_train_state(cfg, model)
    step = tts.make_train_step(cfg, model, task)
    _, logged = step(state, torch_batch(arrays, task), make_key(6, device="cpu"))
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return {k: float(v) for k, v in logged.items()}, grads


def _counting(monkeypatch, module):
    calls = []
    inner = module.checkpoint

    def counted(fn, *args, **kwargs):
        calls.append(fn)
        return inner(fn, *args, **kwargs)

    monkeypatch.setattr(module, "checkpoint", counted)
    return calls


def _hold(plain, remat):
    (lp, gp), (lr, gr) = plain, remat
    assert lp == lr  # bit for bit
    assert set(gp) == set(gr) and gp
    for k, g in gp.items():
        scale = float(g.abs().max())
        err = float((gr[k] - g).abs().max())
        assert err <= 1e-6 * max(scale, 1e-30), (k, err, scale)


@pytest.mark.parametrize("task", ["detection", "sot", "grounding"])
def test_remat_heads_step_equals_unchecked(monkeypatch, task):
    torch.set_num_threads(1)
    _, cfg = train_cfgs()
    arrays = tiny_train_arrays(cfg)
    plain = _step(cfg, task, arrays)
    calls = _counting(monkeypatch, decoder_mod)
    remat_cfg = cfg.replace(decoder=dataclasses.replace(cfg.decoder, remat_heads=True))
    remat = _step(remat_cfg, task, arrays)
    assert len(calls) == cfg.decoder.num_layers + 1  # every head call of the forward
    _hold(plain, remat)


def test_swin_checkpoint_step_equals_unchecked(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setitem(swin.VARIANTS, "swin_remat_test", SWIN_SMALL)
    _, cfg = train_cfgs()
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone, name="swin_remat_test",
                                                   swin_window_size=3))
    arrays = tiny_train_arrays(cfg, H=60, W=68)  # stage maps 15x17 ... 2x3: all padded
    plain = _step(cfg, "detection", arrays)
    calls = _counting(monkeypatch, swin)
    remat_cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone, swin_use_checkpoint=True),
                            decoder=dataclasses.replace(cfg.decoder, remat_heads=True))
    remat = _step(remat_cfg, "detection", arrays)
    assert len(calls) == sum(SWIN_SMALL["depths"])
    _hold(plain, remat)


def test_checkpointing_is_training_only():
    """Outside autograd (inference, the BoxVIS teacher) nothing is
    checkpointed and the outputs are those of the unchecked model."""
    torch.set_num_threads(1)
    _, cfg = train_cfgs()
    arrays = tiny_train_arrays(cfg)
    outs = []
    for remat in (False, True):
        c = cfg.replace(decoder=dataclasses.replace(cfg.decoder, remat_heads=remat))
        model = build_model(c, None, seed=4, device="cpu")
        b = torch_batch(arrays, "detection")
        kw, *_ = tts._model_inputs(c, b, "detection")
        with torch.no_grad():
            out = model(b.images, b.frame_indices, task="detection", train=True,
                        shuffle_key=make_key(1, device="cpu"), **kw)
        outs.append(out["pred_masks"])
    assert torch.equal(*outs)
    assert np.isfinite(outs[0].numpy()).all()
