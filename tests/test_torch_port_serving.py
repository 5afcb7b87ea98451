"""The PyTorch port's serving path against the JAX package.

The lane-multiplexed step and the HTTP server of the port run on the CPU
beside the JAX ``multiplex`` programs and ``MuxEngine``, on the same
weights (carried through ``state_dict_from_jax``) and the same frames
(numpy, seeded). float32, tiny config with the fused ViT attention.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG
from videocad_tpu.infer import multiplex as jax_mux
from videocad_tpu.infer.rollout import prepare_for_decode as jax_prepare
from videocad_tpu.infer.server import MuxEngine as JaxMuxEngine
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu_torch.infer import multiplex as port_mux
from videocad_tpu_torch.infer.rollout import prepare_for_decode
from videocad_tpu_torch.infer.server import (MuxEngine, ServingClient,
                                             SessionError, make_server)
from videocad_tpu_torch.models import create_model, state_dict_from_jax

LANES = 3
SEQ_LEN = 6
CFG = dict(TINY_CONFIG, vit_attention_impl="fused")


@pytest.fixture(scope="module")
def pair():
    jax_model = jax_create_model(CFG)
    params = init_model(jax_model, jax.random.PRNGKey(11), batch=1,
                        seq_len=2)
    model = create_model(CFG)
    model.load_state_dict(state_dict_from_jax(params))
    return jax_model, params, model


def _imgs(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


def _lane_state(carry, lane):
    parts = [carry["t"][lane], carry["action"][lane],
             carry["cad_stream"][lane]]
    for k, v in carry["self_kv"] + carry["mem_kv"]:
        parts += [k[lane], v[lane]]
    return [p.clone() for p in parts]


def test_mux_interleaved_lanes_match_jax_and_idle_lanes_stay_frozen(pair):
    jax_model, params, model = pair
    jp = jax_prepare(params, jnp.float32)
    jcarry = jax_mux.init_mux_carry(jax_model, params, LANES, SEQ_LEN)
    pp = prepare_for_decode(model)
    pcarry = port_mux.init_mux_carry(model, LANES, SEQ_LEN)
    cads = _imgs(3, seed=1)
    frames = _imgs(12, seed=2)
    fi = iter(range(12))

    def open_(lane, cad):
        nonlocal jcarry, pcarry
        jcarry = jax_mux.open_lane(jax_model, jp, jcarry, jnp.asarray(lane),
                                   jnp.asarray(cad)[None])
        pcarry = port_mux.open_lane(model, pcarry, lane,
                                    torch.from_numpy(cad)[None])

    def tick(lanes, checked=None):
        nonlocal jcarry, pcarry
        f = np.zeros((LANES, 32, 32, 3), np.uint8)
        act = np.zeros((LANES,), bool)
        for lane in lanes:
            f[lane] = frames[next(fi)]
            act[lane] = True
        jcarry, jc, jpar = jax_mux.mux_decode_step(
            jax_model, jp, jnp.asarray(f), jnp.asarray(act), jcarry)
        pcarry, pc, ppar = port_mux.mux_decode_step(
            model, pp, torch.from_numpy(f), torch.from_numpy(act), pcarry)
        for lane in (lanes if checked is None else checked):
            np.testing.assert_allclose(pc[lane].numpy(), np.asarray(jc[lane]),
                                       atol=1e-4, rtol=0)
            np.testing.assert_allclose(ppar[lane].numpy(),
                                       np.asarray(jpar[lane]), atol=1e-4,
                                       rtol=0)
        np.testing.assert_array_equal(pcarry["t"].numpy(),
                                      np.asarray(jcarry["t"]))
        # XLA may divide by 1000 as a product with its reciprocal: the
        # fed-back actions agree to an ulp, their integer actions exactly.
        np.testing.assert_allclose(pcarry["action"].numpy(),
                                   np.asarray(jcarry["action"]), atol=1e-6,
                                   rtol=0)

    open_(0, cads[0])
    tick([0])
    open_(2, cads[1])
    tick([0, 2])
    frozen = _lane_state(pcarry, 0)
    tick([2])                            # lane 0 open but idle
    for before, after in zip(frozen, _lane_state(pcarry, 0)):
        assert torch.equal(before, after)
    jcarry = jax_mux.close_lane(jcarry, 0)
    pcarry = port_mux.close_lane(pcarry, 0)
    frozen = _lane_state(pcarry, 0)
    tick([0, 2], checked=[2])            # a step for a closed lane: inert
    for before, after in zip(frozen, _lane_state(pcarry, 0)):
        assert torch.equal(before, after)
    open_(0, cads[2])                    # the lane is reusable
    tick([0, 2])
    tick([0])
    for (pk, pv), (jk, jv) in zip(pcarry["self_kv"] + pcarry["mem_kv"],
                                  jcarry["self_kv"] + jcarry["mem_kv"]):
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=1e-4)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-4)


def test_port_server_gives_the_jax_engine_actions(pair):
    jax_model, params, model = pair
    engine = MuxEngine(model, lanes=LANES, seq_len=SEQ_LEN)
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    ref = JaxMuxEngine(jax_model, params, lanes=LANES, seq_len=SEQ_LEN)
    try:
        client = ServingClient(f"http://127.0.0.1:{server.server_address[1]}")
        assert client.meta()["lanes"] == LANES
        cads = _imgs(2, seed=3)
        frames = _imgs(2 * SEQ_LEN, seed=4).reshape(2, SEQ_LEN, 32, 32, 3)
        sids = [client.open_session(c) for c in cads]
        ref_sids = [ref.open_session(c)[0] for c in cads]
        want = [[ref.step(rs, f) for f in frames[i]]
                for i, rs in enumerate(ref_sids)]

        got = [[None] * SEQ_LEN for _ in sids]
        # Session 0 steps alone for two steps, then both step at once
        # from their own threads (the batcher coalesces them).
        for s in range(2):
            got[0][s] = client.step(sids[0], frames[0][s])

        def run(i, first):
            for s in range(first, SEQ_LEN):
                got[i][s] = client.step(sids[i], frames[i][s])

        workers = [threading.Thread(target=run, args=(0, 2)),
                   threading.Thread(target=run, args=(1, 0))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
            assert not w.is_alive()
        for i in range(2):
            for s in range(SEQ_LEN):
                g, w = got[i][s], want[i][s]
                assert (g["step"], g["cmd"], g["params"]) == (
                    w["step"], w["cmd"], w["params"]), (i, s)
                np.testing.assert_allclose(g["action"], w["action"],
                                           atol=1e-6)
        with pytest.raises(SessionError) as exc:
            client.step(sids[0], frames[0][0])
        assert exc.value.status == 409                # horizon reached
        with pytest.raises(SessionError) as exc:
            client.step(sids[1], frames[0][0][:8])
        assert exc.value.status in (400, 409)
        for sid in sids:
            client.close_session(sid)
        with pytest.raises(SessionError) as exc:
            client.step(sids[0], frames[0][0])
        assert exc.value.status == 404
        stats = client.stats()
        assert stats["ticks"] > 0 and stats["steps"] == 2 * SEQ_LEN
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        ref.stop()
        thread.join(timeout=10)


# ---- multiview and GenCAD lanes ----

VIEW_CFGS = {
    "multiview": dict(CFG, num_views=2),
    "gencad": dict(CFG, use_pretrained_cad_model=True, vit_patch=32),
}


def _session_images(kind, seed):
    """A session's CAD image (the 256² x 3 edge image under GenCAD) and
    multiview images (2 views, uint8) or None."""
    rng = np.random.default_rng(seed)
    if kind == "gencad":
        return rng.integers(0, 256, (256, 256, 3), dtype=np.uint8), None
    return (rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
            rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))


@pytest.mark.parametrize("kind", sorted(VIEW_CFGS))
def test_mux_lanes_with_views_or_gencad_match_jax(kind):
    """init_mux_carry(multiview=True) sizes the CAD stream for the views;
    open_lane takes the session's multiview images, or the GenCAD edge
    image; the lanes' logits equal JAX's."""
    cfg = VIEW_CFGS[kind]
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(12), batch=1,
                        seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    jp = jax_prepare(params, jnp.float32)
    multiview = kind == "multiview"
    jcarry = jax_mux.init_mux_carry(jax_model, params, 2, SEQ_LEN,
                                    multiview=multiview)
    pcarry = port_mux.init_mux_carry(model, 2, SEQ_LEN, multiview=multiview)
    assert tuple(pcarry["cad_stream"].shape) == tuple(
        jcarry["cad_stream"].shape) == (2, 32 * (2 if multiview else 1))
    pp = prepare_for_decode(model)
    for lane in range(2):
        cad, views = _session_images(kind, seed=lane)
        jcarry = jax_mux.open_lane(
            jax_model, jp, jcarry, jnp.asarray(lane), jnp.asarray(cad)[None],
            None if views is None else jnp.asarray(views)[None])
        pcarry = port_mux.open_lane(
            model, pcarry, lane, torch.from_numpy(cad)[None],
            None if views is None else torch.from_numpy(views)[None])
    np.testing.assert_allclose(pcarry["cad_stream"].numpy(),
                               np.asarray(jcarry["cad_stream"]), atol=1e-5)
    frames = _imgs(2 * 3, seed=5).reshape(3, 2, 32, 32, 3)
    active = np.ones((2,), bool)
    for f in frames:
        jcarry, jc, jpar = jax_mux.mux_decode_step(
            jax_model, jp, jnp.asarray(f), jnp.asarray(active), jcarry)
        pcarry, pc, ppar = port_mux.mux_decode_step(
            model, pp, torch.from_numpy(f), torch.from_numpy(active), pcarry)
        np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-4)
        np.testing.assert_allclose(ppar.numpy(), np.asarray(jpar), atol=1e-4)


@pytest.mark.parametrize("kind", sorted(VIEW_CFGS))
def test_server_sessions_with_views_or_gencad(kind):
    """The session request carries the GenCAD edge image or the multiview
    images; the engine's actions are the JAX engine's; what the JAX server
    refuses is refused (400)."""
    cfg = VIEW_CFGS[kind]
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(13), batch=1,
                        seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    engine = MuxEngine(model, lanes=2, seq_len=SEQ_LEN)
    ref = JaxMuxEngine(jax_model, params, lanes=2, seq_len=SEQ_LEN)
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = ServingClient(f"http://127.0.0.1:{server.server_address[1]}")
        cad, views = _session_images(kind, seed=3)
        sid = client.open_session(cad, views)
        ref_sid = ref.open_session(cad, views)[0]
        for f in _imgs(3, seed=6):
            got, want = client.step(sid, f), ref.step(ref_sid, f)
            assert (got["cmd"], got["params"]) == (want["cmd"],
                                                   want["params"])
        bad = [(np.zeros((16, 16, 3), np.uint8), views)]     # wrong CAD size
        if kind == "multiview":
            # 1-channel views are refused, as the JAX server refuses them.
            bad += [(cad, None), (cad, views[:1]),
                    (cad, views.astype(np.float32)), (cad, views[..., :1])]
        else:
            bad += [(cad, np.zeros((2, 32, 32, 3), np.uint8))]
        for c, v in bad:
            with pytest.raises(SessionError) as exc:
                client.open_session(c, v)
            assert exc.value.status == 400
        assert engine.meta()["free_lanes"] == 1           # no lane leaked
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        ref.stop()
        thread.join(timeout=30)


def test_port_and_jax_servers_refuse_views_alike():
    """The multiview session check is JAX's: views of (V, H, W, 3) uint8
    only. A (V, H, W, 1) request, or any other shape, gets the same status
    from both servers, and a good one opens on both."""
    cfg = VIEW_CFGS["multiview"]
    jax_model = jax_create_model(cfg)
    params = init_model(jax_model, jax.random.PRNGKey(14), batch=1,
                        seq_len=2)
    model = create_model(cfg)
    model.load_state_dict(state_dict_from_jax(params))
    cad, views = _session_images("multiview", seed=7)
    requests = [views[..., :1], views[:, :16], views[None],
                np.repeat(views, 2, axis=0)[:3], views]
    statuses = []
    for engine in (MuxEngine(model, lanes=2, seq_len=SEQ_LEN),
                   JaxMuxEngine(jax_model, params, lanes=2,
                                seq_len=SEQ_LEN)):
        got = []
        try:
            for v in requests:
                try:
                    engine.close_session(engine.open_session(cad, v)[0])
                    got.append(201)
                except SessionError as e:
                    got.append(e.status)
                except Exception as e:  # noqa: BLE001
                    got.append(getattr(e, "status", type(e).__name__))
            assert engine.meta()["free_lanes"] == 2
        finally:
            engine.stop()
        statuses.append(got)
    assert statuses[0] == statuses[1] == [400, 400, 400, 400, 201]
