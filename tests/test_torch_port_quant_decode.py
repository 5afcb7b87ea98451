"""The port's weight-only quantized decode against the JAX package.

``weight_quant`` "int8" / "int4" (w8a16 / w4a16): the decoder's integers
and scales, the int4 packing, the quantized rollout and the quantized
serving engine, each beside ``videocad_tpu`` on the same weights (carried
through ``state_dict_from_jax``) and the same numpy-seeded inputs, float32,
a tiny config (hidden 64, image 32) with the fused ViT attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG
from videocad_tpu.infer.rollout import quantize_for_decode as jax_quantize
from videocad_tpu.infer.rollout import sequential_inference as jax_rollout
from videocad_tpu.infer.server import MuxEngine as JaxMuxEngine
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu_torch.infer.rollout import (dequantized_weight, pack_int4,
                                              quantize_for_decode,
                                              sequential_inference,
                                              unpack_int4)
from videocad_tpu_torch.infer.server import MuxEngine
from videocad_tpu_torch.models import create_model, state_dict_from_jax

CFG = dict(TINY_CONFIG, hidden_size=64, dim_feedforward=64,
           vit_attention_impl="fused")
BITS = {"int8": 8, "int4": 4}


@pytest.fixture(scope="module")
def pair():
    jax_model = jax_create_model(CFG)
    params = init_model(jax_model, jax.random.PRNGKey(21), batch=1,
                        seq_len=2)
    model = create_model(CFG)
    model.load_state_dict(state_dict_from_jax(params))
    return jax_model, params, model


def _uint8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


def _denses(tree, prefix=""):
    """(path, dense) of every quantized dense of a decode tree."""
    for key, node in tree.items():
        if isinstance(node, dict):
            if {"kernel_q", "weight_q", "weight_q4"} & node.keys():
                yield prefix + key, node
            else:
                yield from _denses(node, prefix + key + "/")


@pytest.mark.parametrize("mode", sorted(BITS))
def test_quantized_integers_and_scales_equal_jax(pair, mode):
    """Every dense of the decoder (q/k/v fused) has JAX's integers exactly
    and its per-output-channel scale within one float32 ulp; the other
    decoder leaves are cast, the rest of the tree is shared, not copied."""
    _, params, model = pair
    want = dict(_denses(jax_quantize(params, jnp.float32,
                                     BITS[mode])["decoder"]))
    got_tree = quantize_for_decode(model, torch.float32, bits=BITS[mode])
    got = dict(_denses(got_tree["decoder"]))
    # Per layer: self qkv and out, cross q, k, v, out, linear1, linear2.
    assert sorted(got) == sorted(want) and len(got) == 2 * 8
    for path, dense in got.items():
        ref = want[path]
        # ml_dtypes int4 -> int8 before comparing; (in, out) -> (out, in).
        ints = np.asarray(ref["kernel_q"]).astype(np.int8).T
        np.testing.assert_array_equal(dequantized_weight(dense).numpy(),
                                      ints, err_msg=path)
        np.testing.assert_array_max_ulp(dense["scale"].numpy(),
                                        np.asarray(ref["scale"])[0], 1)
        np.testing.assert_array_equal(dense["bias"].numpy(),
                                      np.asarray(ref["bias"]))
        if mode == "int4":
            assert dense["weight_q4"].dtype == torch.uint8
            assert dense["weight_q4"].shape[1] == (dense["in_features"]
                                                   + 1) // 2
        else:
            assert dense["weight_q"].dtype == torch.int8
    norm = got_tree["decoder"]["layers_1"]["norm2"]["weight"]
    assert torch.equal(norm, model.decoder.layers_1.norm2.weight)
    emb = got_tree["embed_action"]["weight"]
    assert emb.data_ptr() == model.embed_action.weight.data_ptr()


@pytest.mark.parametrize("shape", [(3, 8), (5, 7), (1, 1), (4, 33)])
def test_int4_pack_round_trip(shape):
    """Two's-complement nibbles packed two to a byte along the input axis,
    an odd width padded with a zero: the round trip is exact."""
    q = torch.from_numpy(np.random.default_rng(sum(shape)).integers(
        -8, 8, shape, dtype=np.int8))
    packed = pack_int4(q)
    assert packed.dtype == torch.uint8
    assert tuple(packed.shape) == (shape[0], (shape[1] + 1) // 2)
    assert torch.equal(unpack_int4(packed, shape[1]), q)
    # Column 2j in the low nibble, 2j + 1 in the high one.
    assert pack_int4(torch.tensor([[1, -1], [-8, 7]],
                                  dtype=torch.int8)).tolist() == [
        [0xF1], [0x78]]
    assert pack_int4(torch.tensor([[-2]], dtype=torch.int8)).tolist() == [
        [0x0E]]


def _argmax_actions(cmd, par):
    return np.argmax(cmd, axis=-1), np.argmax(par, axis=-1)


@pytest.mark.parametrize("mode", sorted(BITS))
def test_quantized_rollout_equals_jax(pair, mode):
    jax_model, params, model = pair
    frames = _uint8((2, 6, 32, 32, 3), seed=1)
    cad = _uint8((2, 32, 32, 3), seed=2)
    want = jax_rollout(jax_model, params, jnp.asarray(frames),
                       jnp.asarray(cad), weight_quant=mode)
    got = sequential_inference(model, torch.from_numpy(frames),
                               torch.from_numpy(cad), weight_quant=mode)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    for g, w in zip(_argmax_actions(*(x.numpy() for x in got)),
                    _argmax_actions(*(np.asarray(x) for x in want))):
        np.testing.assert_array_equal(g, w)
    # The quantized decode differs from the float one: the mode is on.
    plain = sequential_inference(model, torch.from_numpy(frames),
                                 torch.from_numpy(cad))
    assert not torch.equal(plain[1], got[1])


@pytest.mark.parametrize("mode", sorted(BITS))
def test_quantized_decode_needs_action_feedback(mode):
    model = create_model(dict(CFG, enable_past_actions=False))
    with pytest.raises(ValueError, match="enable_past_actions"):
        sequential_inference(model, torch.zeros((1, 2, 32, 32, 3),
                                                dtype=torch.uint8),
                             torch.zeros((1, 32, 32, 3), dtype=torch.uint8),
                             weight_quant=mode)
    with pytest.raises(ValueError, match="enable_past_actions"):
        MuxEngine(model, lanes=1, seq_len=4, weight_quant=mode)


@pytest.mark.parametrize("mode", sorted(BITS))
def test_quantized_mux_engine_gives_the_jax_engine_actions(pair, mode):
    """MuxEngine(weight_quant=...) quantizes once at construction and
    serves JAX's actions: 2 lanes, 4 steps, interleaved."""
    jax_model, params, model = pair
    engine = MuxEngine(model, lanes=2, seq_len=6, weight_quant=mode)
    ref = JaxMuxEngine(jax_model, params, lanes=2, seq_len=6,
                       weight_quant=mode)
    try:
        assert engine.meta()["weight_quant"] == mode
        assert "scale" in engine.params["decoder"]["layers_0"]["linear1"]
        cads = _uint8((2, 32, 32, 3), seed=3)
        frames = _uint8((2, 4, 32, 32, 3), seed=4)
        sids = [engine.open_session(c)[0] for c in cads]
        ref_sids = [ref.open_session(c)[0] for c in cads]
        for s in range(4):
            for i in range(2):
                got = engine.step(sids[i], frames[i][s])
                want = ref.step(ref_sids[i], frames[i][s])
                assert (got["step"], got["cmd"], got["params"]) == (
                    want["step"], want["cmd"], want["params"]), (i, s)
                np.testing.assert_allclose(got["action"], want["action"],
                                           atol=1e-6)
    finally:
        engine.stop()
        ref.stop()
