"""The plain reference against the port's plain paths on the CPU, at a
tiny configuration in float32: one train step's three steps (dropout
replayed), one rollout.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, synthetic
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.reference.decode import fed_back, mask_params, token_gaps
from benchmark.tests.tiny import TINY_MODEL


def _cfg(name: str = "flagship"):
    return dict(harness.load_json("configs", name)["model"], **TINY_MODEL)


def _port(cfg, weights):
    from videocad_tpu_torch.models.videocadformer import (
        VideoCADFormer, VideoCADFormerConfig)

    model = VideoCADFormer(VideoCADFormerConfig.from_json(cfg))
    model.load_state_dict({k: v.clone() for k, v in weights.items()})
    return model


def _batch(seed: int, b: int = 2, t: int = 7, size: int = 64):
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    return {"frames": synthetic.pixels(gen, (b, t, size, size, 3), "cpu"),
            "cad_image": synthetic.pixels(gen, (b, size, size, 3), "cpu"),
            "actions": torch.from_numpy(synthetic.padded_actions(
                rng, [t, t - 2], t)).float()}


def test_param_spec_names_every_port_parameter():
    # The flagship, and the same with the GenCAD CAD encoder.
    for gencad in (False, True):
        cfg = dict(_cfg(), use_pretrained_cad_model=gencad)
        model = _port(cfg, ref_model.make_weights(cfg, 0, "cpu"))
        spec = {n: shape for n, shape, _, _ in ref_model.param_spec(cfg)}
        assert spec == {n: tuple(p.shape)
                        for n, p in model.named_parameters()}


def test_three_train_steps_match_the_port():
    from videocad_tpu_torch.train import (REFERENCE_CMD_WEIGHTS, LossConfig,
                                          create_train_state,
                                          make_train_step)

    cfg = _cfg()
    weights = ref_model.make_weights(cfg, 11, "cpu")
    model = _port(cfg, weights)
    state = create_train_state(dict(model.named_parameters()), {"lr": 1e-3})
    step = make_train_step(model, LossConfig(REFERENCE_CMD_WEIGHTS))
    trainer = ref_train.Trainer(cfg, weights, 1e-3)
    norms = []
    for i in range(3):
        batch = _batch(i)
        state, loss, _ = step(state, batch, 2 ** 31 + 5)
        ref_loss, grads = trainer.step(batch, 2 ** 31 + 5)
        norms.append(grads)
        assert float(loss) == pytest.approx(ref_loss, rel=2e-6)
    median = torch.stack(list(norms[0].values())).median()
    for name, p in model.named_parameters():
        # Adam after three steps: a leaf whose gradient is nought but for
        # round-off (a key's bias under softmax) moves by round-off; the
        # rest agree to float32 rounding.
        if norms[0][name] < 1e-3 * median:
            continue
        diff = (p.detach() - trainer.params[name].detach()).abs()
        assert float(diff.median()) < 1e-6, name


def test_a_rollout_matches_the_port():
    from videocad_tpu_torch.infer.rollout import sequential_inference

    cfg = _cfg()
    weights = ref_model.make_weights(cfg, 12, "cpu")
    model = _port(cfg, weights).eval()
    batch = _batch(3, t=6)
    cmd, par = sequential_inference(model, batch["frames"],
                                    batch["cad_image"])
    cmd_tok, par_tok = cmd.argmax(-1), par.argmax(-1)
    actions = torch.cat([cmd_tok[..., None],
                         mask_params(cmd_tok, par_tok.clone())], dim=-1)
    ref_cmd, ref_par = ref_model.forward(weights, cfg, batch["frames"],
                                         fed_back(actions),
                                         batch["cad_image"])
    assert torch.allclose(cmd, ref_cmd, atol=1e-4)
    assert torch.allclose(par, ref_par, atol=1e-4)
    gaps = token_gaps(weights, cfg, batch["frames"], batch["cad_image"],
                      actions, param_tokens=par_tok)
    assert gaps.numel() == 2 * 6 * 7 and float(gaps.max()) < 1e-4
