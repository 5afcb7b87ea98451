"""The batch rollout's decode step captured once as a CUDA graph and
replayed over the horizon (``infer/rollout.py:sequential_inference``).

On a CUDA device the rollout replays one captured step T times; the
``cuda`` tests hold it to the same step run eagerly on the card, and to its
two counters. On the CPU the step runs eagerly (the JAX parity tests in
``tests/test_torch_port_model.py`` hold it) and nothing is captured.

The file imports neither jax nor the JAX package, so on a machine without
jax its card tests run without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_rollout_graph.py -q
"""

import gc

import numpy as np
import pytest
import torch

from videocad_tpu_torch.infer import rollout
from videocad_tpu_torch.infer.rollout import sequential_inference
from videocad_tpu_torch.models import create_model

# The flagship's wiring in miniature: past actions, states and timestep
# embedding, a 2-layer decoder of 4 heads, a 10-frame window, bf16.
CFG = dict(hidden_size=64, num_decoder_layers=2, dim_feedforward=128,
           nhead=4, dropout=0.0, encoder="vit", enable_past_actions=True,
           enable_past_states=True, enable_timestep_embedding=True,
           window_size=10, image_size=32, vit_patch=16, vit_dim=16,
           vit_depth=1, vit_heads=2, vit_head_dim=8, vit_mlp_dim=16,
           dtype="bfloat16", vit_attention_impl="fused")


def _model(device, seed=0):
    return create_model(CFG, device=device,
                        generator=torch.Generator().manual_seed(seed))


def _inputs(b, t, seed, device):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, t, 32, 32, 3), dtype=np.uint8)
    cad = rng.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)
    return (torch.from_numpy(frames).to(device),
            torch.from_numpy(cad).to(device))


def _counts():
    return (sequential_inference.graph_captures,
            sequential_inference.graph_replays)


@torch.no_grad()
def _eager(model, frames, cad, action, weight_quant):
    """The rollout's step body run eagerly, op by op, on the model's
    device: what the captured graph replays."""
    memory, _ = model.encode_context(cad, frames, None, frames.shape[1])
    inputs = rollout._step_inputs(model, memory, weight_quant)
    return rollout._run_eagerly(model.config, inputs, frames.shape[0],
                                frames.shape[1], action)


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("weight_quant", ["none", "int8"])
def test_cpu_rollout_runs_eagerly_and_counts_nothing(weight_quant):
    model = _model("cpu")
    frames, cad = _inputs(2, 12, seed=1, device="cpu")
    got = sequential_inference(model, frames, cad,
                               weight_quant=weight_quant)
    want = _eager(model, frames, cad, True, weight_quant)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert _counts() == (0, 0)
    assert model not in rollout._graphs


class _FakeGraphed:
    """Stands in for the captured rollout, to hold the cache's logic on
    the CPU: each instance is one capture."""

    made = []

    def __init__(self, cfg, inputs, rows, seq_len, action):
        self.key = (rows, seq_len, action)
        _FakeGraphed.made.append(self.key)

    def __call__(self, inputs):
        return self.key


def test_graph_cache_is_a_small_lru_per_model_that_goes_with_it(
        monkeypatch):
    monkeypatch.setattr(rollout, "_GraphedRollout", _FakeGraphed)
    monkeypatch.setattr(_FakeGraphed, "made", [])
    model = _model("cpu")
    size = rollout._GRAPHS_PER_MODEL

    def call(seq_len, rows=2, action=True, weight_quant="none"):
        return rollout._replay(model, {}, rows, seq_len, weight_quant,
                               action)

    assert call(5) == (2, 5, True)
    assert call(5) == (2, 5, True)                  # a hit: no capture
    assert call(5, action=False) == (2, 5, False)   # each key its own
    call(5, rows=1)
    call(5, weight_quant="int8")
    assert len(_FakeGraphed.made) == 4
    call(5)                                 # (2, 5) is the newest again
    for seq_len in range(6, 6 + size - 1):  # evicts all but (2, 5)
        call(seq_len)
    cache = rollout._graphs[model]
    assert len(cache) == size
    made = len(_FakeGraphed.made)
    call(5)
    assert len(_FakeGraphed.made) == made   # kept: most recently used
    call(5, action=False)
    assert len(_FakeGraphed.made) == made + 1   # evicted, so captured anew
    assert len(cache) == size
    del model, cache
    gc.collect()
    assert len(rollout._graphs) == 0        # the graphs went with the model


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rollout is captured only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("weight_quant", ["none", "int8"])
@pytest.mark.parametrize("action", [True, False])
def test_graphed_rollout_equals_its_eager_body(cuda, weight_quant, action):
    """The replays launch the eager step's kernels on the same buffers, so
    the logits agree bit for bit, and with them every argmax."""
    model = _model(cuda)
    frames, cad = _inputs(2, 24, seed=2, device=cuda)
    captures, replays = _counts()
    got = sequential_inference(model, frames, cad, action=action,
                               weight_quant=weight_quant)
    assert _counts() == (captures + 1, replays + 24)
    want = _eager(model, frames, cad, action, weight_quant)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert torch.equal(g.argmax(-1), w.argmax(-1))
    again = sequential_inference(model, frames, cad, action=action,
                                 weight_quant=weight_quant)
    assert _counts() == (captures + 1, replays + 48)
    for g, a in zip(got, again):
        torch.testing.assert_close(a, g, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("weight_quant", ["none", "int8"])
def test_graphed_rollout_decodes_with_the_current_weights(cuda,
                                                          weight_quant):
    """A decoder weight changed in place between calls (the trainer's
    evaluation between epochs) is read by the next call's replays: the
    inputs are refreshed, not captured again."""
    model = _model(cuda)
    frames, cad = _inputs(2, 24, seed=3, device=cuda)
    before = sequential_inference(model, frames, cad,
                                  weight_quant=weight_quant)
    captures, replays = _counts()
    with torch.no_grad():
        model.decoder.layers_0.linear1.weight.mul_(-1.5)
        model.predict_cmd.bias.add_(0.25)
    after = sequential_inference(model, frames, cad,
                                 weight_quant=weight_quant)
    assert _counts() == (captures, replays + 24)
    want = _eager(model, frames, cad, True, weight_quant)
    for g, w, b in zip(after, want, before):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert not torch.equal(g, b)


@pytest.mark.cuda
def test_another_horizon_captures_once_more(cuda):
    model = _model(cuda)
    captures, replays = _counts()
    for seq_len in (24, 7, 24, 7):      # T = 7 < the window of 10
        frames, cad = _inputs(2, seq_len, seed=seq_len, device=cuda)
        got = sequential_inference(model, frames, cad)
        want = _eager(model, frames, cad, True, "none")
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert _counts() == (captures + 2, replays + 2 * (24 + 7))


@pytest.mark.cuda
def test_successive_calls_return_their_own_tensors(cuda):
    model = _model(cuda)
    first_in = _inputs(2, 24, seed=4, device=cuda)
    first = sequential_inference(model, *first_in)
    kept = [x.clone() for x in first]
    second = sequential_inference(model, *_inputs(2, 24, seed=5,
                                                  device=cuda))
    for a, b, k in zip(first, second, kept):
        assert a.data_ptr() != b.data_ptr()
        assert not torch.equal(a, b)
        torch.testing.assert_close(a, k, rtol=0, atol=0)
