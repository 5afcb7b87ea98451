"""The port's int8 dense layers (``videocad_tpu_torch/ops/quant.py`` and
``quant`` in the models) against the JAX package's ``ops/quant.py``.

The JAX side runs under ``jax.jit``, the arithmetic its train step and
rollout compile to: XLA takes the scale's ``/ 127`` as a product with the
float32 reciprocal, which the port computes, so the integers are equal.
Inputs are made with numpy from a seed; model weights come from the JAX
``init_model`` through ``state_dict_from_jax``; everything is float32
unless a case says otherwise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG
from tests.test_torch_port_model import _u8
from tests.test_torch_port_train import _is_key_bias
from videocad_tpu.infer.rollout import sequential_inference as jax_rollout
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu.models.videocadformer import VideoCADFormer as JaxModel
from videocad_tpu.ops import quant as jq
from videocad_tpu.train import objective as jax_objective
from videocad_tpu.train import steps as jax_steps
from videocad_tpu_torch.cli import train as port_cli
from videocad_tpu_torch.data import synthetic as port_synthetic
from videocad_tpu_torch.data.synthetic import write_synthetic_dataset
from videocad_tpu_torch.infer.rollout import sequential_inference
from videocad_tpu_torch.models import (create_model, jax_tree_from_state_dict,
                                       state_dict_from_jax)
from videocad_tpu_torch.ops import quant
from videocad_tpu_torch.train import objective as port_objective
from videocad_tpu_torch.train import steps as port_steps

JAX_LOSS = jax_objective.LossConfig(jax_objective.REFERENCE_CMD_WEIGHTS)
PORT_LOSS = port_objective.LossConfig(port_objective.REFERENCE_CMD_WEIGHTS)
# (M, K, N): a ViT-like row count, M <= 16, K and N off the multiple of 8.
SHAPES = [(40, 32, 24), (5, 16, 8), (33, 20, 13), (1, 7, 3)]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    # Rows of very different magnitudes, and one all-zero row and column:
    # the scale's floor keeps them finite.
    x = (rng.standard_normal((m, k)) * rng.uniform(0.01, 5.0, (m, 1)))
    w = rng.standard_normal((k, n)) * 0.2
    x[0] = 0.0
    w[:, -1] = 0.0
    return x.astype(np.float32), w.astype(np.float32)


def _jit_quantize(x, axis):
    return jax.jit(lambda a: (jq._rowwise_scale(a, axis),
                              jq._to_int8(a, jq._rowwise_scale(a, axis))))(x)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_matmul_forward_matches_jax(shape, dtype):
    m, k, n = shape
    x, w = _operands(m, k, n, seed=m + k + n)
    jx = jnp.asarray(x).astype(dtype)
    jw = jnp.asarray(w).astype(dtype)
    tx = torch.from_numpy(x).to(TORCH_DTYPES[dtype])
    tw = torch.from_numpy(w).to(TORCH_DTYPES[dtype])
    # Scales and integers, per row of x and per column of w.
    for jarr, tarr, axis in ((jx, tx, -1), (jw, tw, 0)):
        want_s, want_q = _jit_quantize(jarr, axis)
        got_s = quant._rowwise_scale(tarr, axis)
        got_q = quant._to_int8(tarr, got_s)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        assert got_q.dtype == torch.int8
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    # The int32 accumulators.
    _, qx = _jit_quantize(jx, -1)
    _, qw = _jit_quantize(jw, 0)
    want_acc = jax.lax.dot_general(qx, qw, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    got_acc = quant._int_matmul(torch.from_numpy(np.asarray(qx)),
                                torch.from_numpy(np.asarray(qw)))
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    # The rescaled output.
    want = np.asarray(jax.jit(jq.q8_matmul)(jx, jw).astype(jnp.float32))
    got = quant.q8_matmul(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("backward", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [(2, 20, 32, 24), (1, 5, 13, 9)])
def test_q8_matmul_backward_matches_jax_vjp(backward, shape):
    b, t, k, n = shape
    x, w = _operands(b * t, k, n, seed=k * n)
    x = x.reshape(b, t, k)
    dy = np.random.default_rng(1).standard_normal((b, t, n)).astype(
        np.float32)

    def vjp(xa, wa, g):
        _, pull = jax.vjp(lambda a, c: jq.q8_matmul(a, c, backward), xa, wa)
        return pull(g)

    want_dx, want_dw = jax.jit(vjp)(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    quant.q8_matmul(tx, tw, backward).backward(torch.from_numpy(dy))
    for got, want in ((tx.grad, want_dx), (tw.grad, want_dw)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    if backward == "bf16":
        # Straight through: the plain matmul's gradients.
        xr = torch.from_numpy(x).requires_grad_()
        wr = torch.from_numpy(w).requires_grad_()
        (xr @ wr).backward(torch.from_numpy(dy))
        torch.testing.assert_close(tx.grad, xr.grad, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(tw.grad, wr.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bias", [True, False])
def test_quantized_dense_matches_jax(bias):
    x, kernel = _operands(24, 16, 12, seed=5)
    b = np.random.default_rng(2).standard_normal(12).astype(np.float32)
    want = jax.jit(lambda a, c, d: jq.quantized_dense(
        a, c, d, jnp.float32))(x, kernel, b if bias else None)
    got = quant.quantized_dense(
        torch.from_numpy(x), torch.from_numpy(kernel.T.copy()),
        torch.from_numpy(b) if bias else None, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (16, 24, 16), (17, 8, 8),
                                   (3, 5, 7), (40, 33, 1)])
def test_int_product_padding_keeps_the_sums_exact(m, k, n):
    """``torch._int_mm`` takes M > 16 and K, N multiples of 8 on the card:
    zero padding gives those shapes and leaves every sum exact."""
    rng = np.random.default_rng(m * k * n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    pa, pb = quant._pad_operands(a, b)
    assert pa.shape[0] > 16 and pa.shape[1] % 8 == 0 and pb.shape[1] % 8 == 0
    assert pa.shape[1] == pb.shape[0]
    assert torch.equal(pa[:m, :k], a) and torch.count_nonzero(pa) == \
        torch.count_nonzero(a)
    got = quant._int_matmul(a, b)
    want = a.to(torch.int64) @ b.to(torch.int64)
    assert got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64), want)
    assert quant._q8_dot.launches == 0    # counted on a CUDA tensor only


def test_parameter_trees_are_the_same_under_each_quant():
    trees = {q: create_model(dict(TINY_CONFIG, quant=q)).state_dict()
             for q in quant.MODES}
    base = trees["none"]
    for q, tree in trees.items():
        assert list(tree) == list(base), q
        for key in base:
            assert tree[key].shape == base[key].shape
            assert tree[key].dtype == torch.float32
    model = create_model(dict(TINY_CONFIG, quant="int8_bwd"))
    model.load_state_dict(base)
    with pytest.raises(ValueError, match="unknown quant"):
        create_model(dict(TINY_CONFIG, quant="int4"))


def _pair(cfg, seed=0):
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(seed), batch=1,
                        seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    return jax_model, params, model


def _batch(seed):
    data = port_synthetic.synthetic_batch_feed(2, 8, image_size=32,
                                               seed=seed)
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.from_numpy(v) for k, v in data.items()})


@pytest.mark.parametrize("mode", ["int8", "int8_bwd"])
def test_flagship_logits_and_gradients_match_jax(mode):
    """A tiny flagship (fused ViT attention) under each mode: logits within
    1e-5, and one step's loss and gradients.

    The gradients are held to 1e-5 of each tensor's largest entry. An
    attention key bias has a zero gradient in exact arithmetic, so both
    packages hold noise there (absolute 1e-6). Under ``int8_bwd`` the
    backward quantizes the cotangents, which the two packages compute to
    within an ulp: where one lands on a rounding boundary, one integer of
    one row differs by one, which moves the entries of one weight-gradient
    row by at most one quantization step, 1/127 of the row's range. Those
    entries are allowed that step and must be fewer than 1e-3 of all.
    """
    cfg = dict(TINY_CONFIG, vit_attention_impl="fused", quant=mode)
    jax_model, params, model = _pair(cfg)
    jax_batch, port_batch = _batch(seed=1)
    inputs, targets = jax_steps.prepare_model_inputs(jax_batch)
    want_logits = jax.jit(lambda p: jax_model.apply({"params": p}, inputs))(
        params)

    def loss_fn(p):
        preds = jax_model.apply({"params": p}, inputs)
        return jax_objective.compute_loss_and_metrics(*preds, targets,
                                                      JAX_LOSS)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port_inputs, port_targets = port_steps.prepare_model_inputs(port_batch)
    with torch.no_grad():
        got_logits = model(port_inputs)
    for got, want in zip(got_logits, want_logits):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
    model.train()
    loss = port_objective.compute_loss_and_metrics(
        *model(port_inputs), port_targets, PORT_LOSS)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    grads = jax_tree_from_state_dict(
        {name: p.grad for name, p in model.named_parameters()})
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    want = dict(jax.tree_util.tree_leaves_with_path(want_grads))
    assert sorted(map(str, got)) == sorted(map(str, want))
    stepped = total = 0
    for path, w in want.items():
        w, g = np.asarray(w), np.asarray(got[path])
        total += w.size
        if _is_key_bias(path):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=str(path))
            continue
        scale = max(np.abs(w).max(), 1e-30)
        off = np.abs(g - w) > 1e-5 * scale
        if mode == "int8":
            assert not off.any(), (path, np.abs(g - w).max() / scale)
        stepped += int(off.sum())
        assert np.all(np.abs(g - w) <= scale / 127), path
    assert stepped <= 1e-3 * total, stepped


@pytest.mark.parametrize("impl", ["fused", "block"])
def test_vit_embedding_matches_jax_under_quant(impl):
    """``"fused"``: the projections around the fused core are quantized;
    ``"block"``: the fused sub-block kernels read the raw weights and only
    the patch embedding is quantized, in both packages."""
    cfg = dict(TINY_CONFIG, vit_attention_impl=impl, quant="int8")
    jax_model, params, model = _pair(cfg, seed=2)
    frames = _u8((2, 3, 32, 32, 3), seed=4)
    want = jax.jit(lambda p, f: jax_model.apply(
        {"params": p}, f, method=JaxModel.encode_frames))(
        params, jnp.asarray(frames))
    with torch.no_grad():
        got = model.encode_frames(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    # Quantization moves the embedding away from the float one.
    plain = create_model(dict(cfg, quant="none"))
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert not torch.allclose(plain.encode_frames(
            torch.from_numpy(frames)), got, atol=1e-5)


def test_rollout_under_quant_matches_jax():
    """The rollout's encoders are quantized (they go through the module);
    its KV-cached decode reads the raw decoder weights in full precision,
    in both packages."""
    cfg = dict(TINY_CONFIG, vit_attention_impl="fused", quant="int8")
    jax_model, params, model = _pair(cfg, seed=6)
    frames = _u8((2, 6, 32, 32, 3), seed=7)
    cad = _u8((2, 32, 32, 3), seed=8)
    want = jax_rollout(jax_model, params, jnp.asarray(frames),
                       jnp.asarray(cad))
    got = sequential_inference(model, torch.from_numpy(frames),
                               torch.from_numpy(cad))
    for g, e in zip(got, want):
        assert g.shape == e.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-5,
                                   rtol=0)


def test_train_cli_runs_with_int8_backward(tmp_path):
    store = str(tmp_path / "store")
    write_synthetic_dataset(store, num_sequences=6, min_len=5, max_len=8,
                            image_size=32, seed=0,
                            split_path=os.path.join(store,
                                                    "dataset_split.json"))
    model_config = str(tmp_path / "model.json")
    with open(model_config, "w") as f:
        json.dump({"tiny": dict(TINY_CONFIG, dropout=0.1,
                                vit_attention_impl="fused",
                                train_config={"experiment_name": "q8"})}, f)
    results = port_cli.main([
        "--device", "cpu", "--epochs", "1", "--quant", "int8_bwd",
        "--dataset_path", store,
        "--config_path", os.path.join(store, "dataset_split.json"),
        "--model_config", model_config, "--model_name", "tiny",
        "--batch_size", "2", "--buckets", "8",
        "--checkpoint_dir", str(tmp_path / "ckpt"),
        "--log_dir", str(tmp_path / "logs"),
        "--class_weights", str(tmp_path / "none.json")])
    assert results["total_predictions"] > 0
    with open(tmp_path / "logs" / "q8" / "params.json") as f:
        assert json.load(f)["quant"] == "int8_bwd"
