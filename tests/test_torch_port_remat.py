"""``remat_encoder`` and ``frame_chunk`` in the port's models, against the
JAX package's models and against the port without them.

With dropout on, the backward's recompute of the state encoder must draw
the forward's masks: the port's dropout generators (``DropoutRng``) are
explicit and move with every draw, and ``torch.utils.checkpoint`` restores
only the default ones, so ``models/layers.py:remat`` saves and sets them
itself, and the modules' train mode, which the train step resets before
the backward. The tests here hold the gradients with remat EQUAL to those
without, and show that a naive ``checkpoint`` wrap breaks that. Inputs are
made with numpy from a seed, weights carried from the JAX ``init_model``;
float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from tests.helpers import TINY_CONFIG
from tests.test_torch_port_model import _u8
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu.train import objective as jax_objective
from videocad_tpu.train import steps as jax_steps
from videocad_tpu_torch.data import synthetic as port_synthetic
from videocad_tpu_torch.models import (create_model, jax_tree_from_state_dict,
                                       state_dict_from_jax)
from videocad_tpu_torch.models import resnet as port_resnet
from videocad_tpu_torch.models import vit as port_vit
from videocad_tpu_torch.ops.dropout import DropoutRng
from videocad_tpu_torch.train import objective as port_objective
from videocad_tpu_torch.train import state as port_state
from videocad_tpu_torch.train import steps as port_steps

JAX_LOSS = jax_objective.LossConfig(jax_objective.REFERENCE_CMD_WEIGHTS)
PORT_LOSS = port_objective.LossConfig(port_objective.REFERENCE_CMD_WEIGHTS)
FUSED = dict(TINY_CONFIG, vit_attention_impl="fused")
# The decision transformer on ResNet18-GN at a small width.
DT = dict(TINY_CONFIG, model_family="decision_transformer", encoder="resnet",
          hidden_size=32, n_layer=1, n_head=2, enable_past_actions=False,
          image_size=32)


def _batch(seed, b=2, t=8):
    data = port_synthetic.synthetic_batch_feed(b, t, image_size=32,
                                               seed=seed)
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.from_numpy(v) for k, v in data.items()})


def _grads(model):
    return {name: p.grad.clone() for name, p in model.named_parameters()
            if p.grad is not None}


def _step(cfg, state, port_batch, seed=5):
    """One forward and backward in train() mode with a DropoutRng from
    ``seed``: (loss, gradients, the generators' states after it)."""
    model = create_model(cfg)
    model.load_state_dict(state)
    model.train()
    rng = DropoutRng(seed)
    inputs, targets = port_steps.prepare_model_inputs(port_batch)
    loss = port_objective.compute_loss_and_metrics(
        *model(inputs, rng=rng), targets, PORT_LOSS)[0]
    loss.backward()
    return (loss.detach(), _grads(model),
            (rng.seeds.get_state(), rng.bits.get_state()))


def test_remat_logits_and_gradients_match_jax():
    cfg = dict(FUSED, remat_encoder=True)
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(0), batch=1,
                        seq_len=2)
    jax_batch, port_batch = _batch(seed=1)
    inputs, targets = jax_steps.prepare_model_inputs(jax_batch)

    def loss_fn(p):
        preds = jax_model.apply({"params": p}, inputs)
        return jax_objective.compute_loss_and_metrics(*preds, targets,
                                                      JAX_LOSS)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want_logits = jax_model.apply({"params": params}, inputs)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    port_inputs, port_targets = port_steps.prepare_model_inputs(port_batch)
    with torch.no_grad():
        for got, want in zip(model(port_inputs), want_logits):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)
    model.train()
    loss = port_objective.compute_loss_and_metrics(
        *model(port_inputs), port_targets, PORT_LOSS)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    got = dict(jax.tree_util.tree_leaves_with_path(jax_tree_from_state_dict(
        {name: p.grad for name, p in model.named_parameters()})))
    for path, w in jax.tree_util.tree_leaves_with_path(want_grads):
        w = np.asarray(w)
        names = [getattr(p, "key", None) for p in path]
        # An attention key bias has a zero gradient in exact arithmetic:
        # both packages hold noise there.
        tol = 1e-6 if names[-2:] == ["key", "bias"] else \
            1e-5 * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(np.asarray(got[path]), w, rtol=0,
                                   atol=tol, err_msg=str(path))


SETTINGS = {
    "fused_xla": dict(vit_attention_impl="fused", dropout_impl="xla"),
    "fused_pallas": dict(vit_attention_impl="fused", dropout_impl="pallas",
                         ln_impl="pallas"),
    "block_xla": dict(vit_attention_impl="block", dropout_impl="xla"),
    "block_pallas": dict(vit_attention_impl="block", dropout_impl="pallas"),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_remat_with_dropout_gives_the_gradients_without(setting):
    """Dropout 0.1 at every site: the loss, every gradient and the
    generators' states after the step equal, bit for bit, those of the same
    step without remat."""
    cfg = dict(TINY_CONFIG, dropout=0.1, **SETTINGS[setting])
    state = create_model(cfg).state_dict()
    _, port_batch = _batch(seed=2)
    loss, grads, after = _step(cfg, state, port_batch)
    r_loss, r_grads, r_after = _step(dict(cfg, remat_encoder=True), state,
                                     port_batch)
    assert torch.equal(loss, r_loss)
    assert sorted(grads) == sorted(r_grads)
    for name in grads:
        assert torch.equal(grads[name], r_grads[name]), name
    assert all(torch.equal(a, b) for a, b in zip(after, r_after))
    # Dropout is on: another seed gives another loss.
    assert not torch.equal(_step(cfg, state, port_batch, seed=6)[0], loss)


@pytest.mark.parametrize("setting", ["fused_pallas", "block_xla"])
def test_remat_through_the_train_step_gives_the_steps_without(setting):
    """``make_train_step`` puts the model back in eval() mode after its
    forward, before the backward's recompute: two steps with remat give
    the losses, gradients and parameters of the steps without, bit for
    bit, and the model ends in the mode it started in."""
    cfg = dict(TINY_CONFIG, dropout=0.1, **SETTINGS[setting])
    state = create_model(cfg).state_dict()
    _, port_batch = _batch(seed=5)
    runs = []
    for remat in (False, True):
        model = create_model(dict(cfg, remat_encoder=remat))
        model.load_state_dict(state)
        train_state = port_state.create_train_state(
            dict(model.named_parameters()), {"lr": 1e-3})
        step = port_steps.make_train_step(model, PORT_LOSS)
        losses = []
        for _ in range(2):
            train_state, loss, _ = step(train_state, port_batch, 7)
            losses.append(loss)
        assert not model.training
        runs.append((losses, _grads(model), {
            n: p.detach().clone() for n, p in model.named_parameters()}))
    (losses, grads, params), (r_losses, r_grads, r_params) = runs
    assert all(torch.equal(a, b) for a, b in zip(losses, r_losses))
    for name in grads:
        assert torch.equal(grads[name], r_grads[name]), name
        assert torch.equal(params[name], r_params[name]), name


def _kept_bytes(encoder, images, rng):
    """The bytes the encoder's forward keeps for its backward."""
    kept = []

    def pack(t):
        kept.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        encoder(images, rng).sum().backward()
    return sum(kept)


@pytest.mark.parametrize("encoder", ["vit", "resnet"])
def test_remat_keeps_only_the_segments_inputs(encoder):
    """Under remat the state encoder's forward keeps the inputs of its
    segments (the stem and each block), a fraction of what it keeps
    without."""
    cfg = dict(TINY_CONFIG, encoder=encoder, dropout=0.1, vit_depth=3,
               vit_attention_impl="fused")
    kept = {}
    for remat in (False, True):
        model = create_model(dict(cfg, remat_encoder=remat))
        model.train()
        images = torch.rand(6, 32, 32, 1)
        kept[remat] = _kept_bytes(model.state_encoder, images,
                                  DropoutRng(3))
    assert kept[True] < kept[False] / 3, kept


def _naive_remat(module, *args, method=None):
    return checkpoint(method or module, *args, use_reentrant=False)


def test_a_naive_checkpoint_wrap_gets_other_gradients(monkeypatch):
    """The case above with ``torch.utils.checkpoint`` alone: the recompute
    draws other masks, so the state encoder's gradients differ."""
    cfg = dict(TINY_CONFIG, dropout=0.1, **SETTINGS["fused_xla"])
    state = create_model(cfg).state_dict()
    _, port_batch = _batch(seed=2)
    _, grads, _ = _step(cfg, state, port_batch)
    monkeypatch.setattr(port_vit, "remat", _naive_remat)
    _, naive, _ = _step(dict(cfg, remat_encoder=True), state, port_batch)
    differ = [n for n in grads if not torch.equal(grads[n], naive[n])]
    assert differ and all(n.startswith("state_encoder.") for n in differ)


@pytest.mark.parametrize("naive", [False, True])
def test_decision_transformer_remat_with_dropout(naive, monkeypatch):
    """The decision transformer's ResNet state encoder draws no dropout,
    its GPT blocks do, after it: remat keeps the gradients and the
    generators' states after the step; a naive wrap recomputes the same
    encoder too (nothing to redraw), and keeps the gradients as well."""
    cfg = dict(DT, dropout=0.1)
    state = create_model(cfg).state_dict()
    _, port_batch = _batch(seed=3)
    loss, grads, after = _step(cfg, state, port_batch)
    if naive:
        monkeypatch.setattr(port_resnet, "remat", _naive_remat)
    r_loss, r_grads, r_after = _step(dict(cfg, remat_encoder=True), state,
                                     port_batch)
    assert torch.equal(loss, r_loss)
    for name in grads:
        assert torch.equal(grads[name], r_grads[name]), name
    assert all(torch.equal(a, b) for a, b in zip(after, r_after))


def test_decision_transformer_vit_remat_with_dropout():
    cfg = dict(DT, encoder="vit", dropout=0.1, vit_attention_impl="fused")
    state = create_model(cfg).state_dict()
    _, port_batch = _batch(seed=4)
    loss, grads, after = _step(cfg, state, port_batch)
    r_loss, r_grads, r_after = _step(dict(cfg, remat_encoder=True), state,
                                     port_batch)
    assert torch.equal(loss, r_loss)
    for name in grads:
        assert torch.equal(grads[name], r_grads[name]), name
    assert all(torch.equal(a, b) for a, b in zip(after, r_after))


def _encoder_batches(model):
    """The batch sizes the state encoder is called with, recorded."""
    sizes = []
    model.state_encoder.register_forward_hook(
        lambda _m, args, _out: sizes.append(args[0].shape[0]))
    return sizes


def test_frame_chunk_eval_logits_match_jax_and_unchunked():
    cfg = dict(FUSED, frame_chunk=4)          # B*T = 2 * 6 = 12: 3 chunks
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(1), batch=1,
                        seq_len=2)
    frames = _u8((2, 6, 32, 32, 3), seed=5)
    cad = _u8((2, 32, 32, 3), seed=6)
    actions = np.zeros((2, 6, 7), np.float32)
    jax_inputs = {"frames": jnp.asarray(frames), "cad_image": jnp.asarray(cad),
                  "actions": jnp.asarray(actions)}
    want = jax_model.apply({"params": params}, jax_inputs)
    inputs = {"frames": torch.from_numpy(frames),
              "cad_image": torch.from_numpy(cad),
              "actions": torch.from_numpy(actions)}
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    sizes = _encoder_batches(model)
    plain = create_model(dict(cfg, frame_chunk=0))
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model(inputs)
        unchunked = plain(inputs)
    assert sizes == [4, 4, 4]
    for g, w, u in zip(got, want, unchunked):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(g.numpy(), u.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("chunk,train,calls", [
    (5, False, [12]),          # does not divide B*T = 12
    (12, False, [12]),         # not smaller than B*T
    (24, False, [12]),
    (4, True, [12]),           # training mode takes the whole batch
    (6, False, [6, 6]),
])
def test_frame_chunk_condition(chunk, train, calls):
    model = create_model(dict(FUSED, frame_chunk=chunk))
    sizes = _encoder_batches(model)
    model.train(train)
    with torch.no_grad():
        model.encode_frames(torch.from_numpy(_u8((2, 6, 32, 32, 3), 7)))
    assert sizes == calls
