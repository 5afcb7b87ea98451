"""The port's serving artifacts against the live model and the JAX package.

A port ``.vcdx`` (config, meta, float32 weights; no programs) loads back
to a model whose forward, rollout, incremental decode and mux step are
bit-equal to the live port model on the CPU. A ``.vcdx`` written by the
JAX ``export_model`` loads in the port and gives the JAX ExportedModel's
forward and rollout within 1e-5. ``cli/export_model.py`` then
``cli/serve.py --artifact`` serve over HTTP through ``ArtifactMuxEngine``
and ``ArtifactEngine``, and those engines refuse bad requests with the JAX
engines' status codes. float32, a tiny config (hidden 64, image 32).
"""

import json
import threading
import zipfile

import jax
import numpy as np
import pytest
import torch

from tests.helpers import TINY_CONFIG
from videocad_tpu.infer.export import _flatten_params
from videocad_tpu.infer.export import export_model as jax_export_model
from videocad_tpu.infer.export import load_exported as jax_load_exported
from videocad_tpu.infer.server import ArtifactEngine as JaxArtifactEngine
from videocad_tpu.infer.server import \
    ArtifactMuxEngine as JaxArtifactMuxEngine
from videocad_tpu.infer.server import MuxEngine as JaxMuxEngine
from videocad_tpu.infer.server import make_server as jax_make_server
from videocad_tpu.models import create_model as jax_create_model
from videocad_tpu.models import init_model
from videocad_tpu_torch.cli import export_model as port_export_cli
from videocad_tpu_torch.cli import serve as port_serve
from videocad_tpu_torch.infer.export import export_model, load_exported
from videocad_tpu_torch.infer.incremental import (incremental_decode_step,
                                                  init_decode_carry)
from videocad_tpu_torch.infer.multiplex import (init_mux_carry,
                                                mux_decode_step, open_lane)
from videocad_tpu_torch.infer.rollout import (decode_params,
                                              sequential_inference)
from videocad_tpu_torch.infer.server import (ArtifactEngine,
                                             ArtifactMuxEngine,
                                             ServingClient, SessionError,
                                             make_server)
from videocad_tpu_torch.models import create_model, state_dict_from_jax

CFG = dict(TINY_CONFIG, hidden_size=64, dim_feedforward=64,
           vit_attention_impl="fused")
BATCH, BUCKET, LANES = 2, 5, 2


def _uint8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_pair():
    jax_model = jax_create_model(CFG)
    params = init_model(jax_model, jax.random.PRNGKey(41), batch=1,
                        seq_len=2)
    return jax_model, params


@pytest.fixture(scope="module")
def jax_artifact(jax_pair, tmp_path_factory):
    """One JAX artifact with lanes (its decode pair and mux programs)."""
    _, params = jax_pair
    path = str(tmp_path_factory.mktemp("jax") / "tiny.vcdx")
    jax_export_model(CFG, params, BATCH, BUCKET, path, lanes=LANES)
    return path


def _port_model(params):
    model = create_model(CFG)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _equal(got, want):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _carry_equal(got, want):
    for key in ("t", "action", "cad_stream"):
        assert torch.equal(got[key], want[key]), key
    for (gk, gv), (wk, wv) in zip(got["self_kv"] + got["mem_kv"],
                                  want["self_kv"] + want["mem_kv"]):
        assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.parametrize("weight_quant", ["none", "int8", "int4"])
def test_port_artifact_round_trip_is_bit_equal(jax_pair, tmp_path,
                                               weight_quant):
    _, params = jax_pair
    model = _port_model(params)
    path = str(tmp_path / "port.vcdx")
    meta = export_model(CFG, model, BATCH, BUCKET, path,
                        weight_quant=weight_quant, lanes=LANES)
    with zipfile.ZipFile(path) as zf:
        assert sorted(zf.namelist()) == ["config.json", "meta.json",
                                         "params.npz"]
        assert json.loads(zf.read("meta.json")) == meta
    assert meta["format"] == "videocad_tpu_torch"
    assert (meta["batch_size"], meta["bucket_len"], meta["lanes"],
            meta["weight_quant"], meta["multiview"], meta["num_views"]) == (
        BATCH, BUCKET, LANES, weight_quant, False, 0)
    exported = load_exported(path, device="cpu")
    for name, p in model.state_dict().items():
        assert torch.equal(exported.model.state_dict()[name], p), name

    frames = _uint8((BATCH, BUCKET, 32, 32, 3), seed=1)
    cad = _uint8((BATCH, 32, 32, 3), seed=2)
    actions = np.random.default_rng(3).uniform(
        -1, 1, (BATCH, BUCKET - 1, 7)).astype(np.float32)
    with torch.no_grad():
        want = model({"frames": torch.from_numpy(frames[:, :-1]),
                      "actions": torch.from_numpy(actions),
                      "cad_image": torch.from_numpy(cad)})
    _equal(exported.forward(frames[:, :-1], actions, cad), want)
    _equal(exported.rollout(frames, cad), sequential_inference(
        model, torch.from_numpy(frames), torch.from_numpy(cad),
        weight_quant=weight_quant))

    live = decode_params(model, weight_quant)
    carry = exported.decode_init(cad)
    ref = init_decode_carry(model, torch.from_numpy(cad), BUCKET)
    for i in range(BUCKET):
        carry, *got = exported.decode_step(frames[:, i], carry)
        ref, *want = incremental_decode_step(
            model, live, torch.from_numpy(frames[:, i]), ref)
        _equal(got, want)
    _carry_equal(carry, ref)

    carry = exported.mux_open(exported.mux_init(), 1, cad[:1])
    ref = open_lane(model, init_mux_carry(model, LANES, BUCKET), 1,
                    torch.from_numpy(cad[:1]))
    active = np.array([False, True])
    for i in range(3):
        carry, *got = exported.mux_step(frames[:, i], active, carry)
        ref, *want = mux_decode_step(model, live,
                                     torch.from_numpy(frames[:, i]),
                                     torch.from_numpy(active), ref)
        _equal(got, want)
    _carry_equal(carry, ref)

    # Held to the artifact's shapes, as a shape-specialised program is.
    for call in (lambda: exported.forward(frames, actions, cad),
                 lambda: exported.rollout(frames[:1], cad[:1]),
                 lambda: exported.decode_step(frames[0, :1], carry),
                 lambda: exported.mux_step(frames[:, 0], active[:1], carry),
                 lambda: exported.mux_open(carry, 0, cad),
                 lambda: exported.rollout(frames, cad.astype(np.float32)),
                 lambda: exported.rollout(frames, cad, cad[:, None])):
        with pytest.raises(ValueError):
            call()


def test_jax_artifact_loads_in_the_port(jax_pair, jax_artifact):
    """A JAX export_model artifact (format 3, lanes 2): the port reads its
    config, meta and weights, ignores its programs, and its forward,
    rollout and decode step give the JAX ExportedModel's within 1e-5."""
    _, params = jax_pair
    ref = jax_load_exported(jax_artifact)
    exported = load_exported(jax_artifact, device="cpu")
    assert ref.meta["format_version"] == 3 and "format" not in ref.meta
    assert exported.lanes == LANES == ref.meta["mux_lanes"]
    frames = _uint8((BATCH, BUCKET, 32, 32, 3), seed=4)
    cad = _uint8((BATCH, 32, 32, 3), seed=5)
    actions = np.random.default_rng(6).uniform(
        -1, 1, (BATCH, BUCKET - 1, 7)).astype(np.float32)
    pairs = [(exported.forward(frames[:, :-1], actions, cad),
              ref.forward(frames[:, :-1], actions, cad)),
             (exported.rollout(frames, cad), ref.rollout(frames, cad))]
    carry, jcarry = exported.decode_init(cad), ref.decode_init(cad)
    for i in range(BUCKET):
        carry, *got = exported.decode_step(frames[:, i], carry)
        jcarry, *want = ref.decode_step(frames[:, i], jcarry)
        pairs.append((got, want))
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)
            np.testing.assert_array_equal(np.argmax(g.numpy(), -1),
                                          np.argmax(np.asarray(w), -1))


def _serve(engine, make=make_server):
    server = make(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    client = ServingClient(f"http://127.0.0.1:{server.server_address[1]}")

    def close():
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    return client, close


def test_cli_export_then_artifact_engines_serve_over_http(jax_pair,
                                                          tmp_path):
    """cli.export_model.main (JAX weights through --checkpoint, int8, 2
    lanes), then cli.serve --artifact: ArtifactMuxEngine serves the JAX
    MuxEngine(weight_quant="int8")'s actions over HTTP; without lanes the
    artifact serves one session at a time through ArtifactEngine."""
    jax_model, params = jax_pair
    config_path = tmp_path / "configs.json"
    config_path.write_text(json.dumps({"tiny": CFG}))
    npz = tmp_path / "params.npz"
    np.savez(npz, **_flatten_params(params))
    argv = ["--device", "cpu", "--model_config", str(config_path),
            "--model_name", "tiny", "--checkpoint", str(npz),
            "--batch", "1", "--bucket", "6", "--weight_quant", "int8"]
    mux_path, single_path = str(tmp_path / "mux.vcdx"), str(
        tmp_path / "single.vcdx")
    meta = port_export_cli.main(argv + ["--lanes", "2", "--out", mux_path])
    assert meta["lanes"] == 2 and meta["weight_quant"] == "int8"
    port_export_cli.main(argv + ["--no_rollout", "--out", single_path])

    engine = port_serve.build_engine(port_serve.parse_args(
        ["--device", "cpu", "--artifact", mux_path]))
    assert isinstance(engine, ArtifactMuxEngine)
    ref = JaxMuxEngine(jax_model, params, lanes=2, seq_len=6,
                       weight_quant="int8")
    client, close = _serve(engine)
    try:
        got_meta = client.meta()
        assert (got_meta["engine"], got_meta["lanes"], got_meta["seq_len"],
                got_meta["weight_quant"]) == ("artifact-mux", 2, 6, "int8")
        cads = _uint8((2, 32, 32, 3), seed=7)
        frames = _uint8((2, 4, 32, 32, 3), seed=8)
        sids = [client.open_session(c) for c in cads]
        ref_sids = [ref.open_session(c)[0] for c in cads]
        for s in range(4):
            for i in range(2):
                got = client.step(sids[i], frames[i][s])
                want = ref.step(ref_sids[i], frames[i][s])
                assert (got["step"], got["cmd"], got["params"]) == (
                    want["step"], want["cmd"], want["params"]), (i, s)
        stats = client.stats()
        assert stats["steps"] == 8 and stats["p95_tick_ms"] is not None
    finally:
        close()
        ref.stop()

    engine = port_serve.build_engine(port_serve.parse_args(
        ["--device", "cpu", "--artifact", single_path]))
    assert isinstance(engine, ArtifactEngine)
    client, close = _serve(engine)
    try:
        sid = client.open_session(cads[0])
        with pytest.raises(SessionError) as exc:
            client.open_session(cads[1])
        assert exc.value.status == 503        # one session at a time
        assert [client.step(sid, f)["step"] for f in frames[0]] == [0, 1,
                                                                     2, 3]
        client.close_session(sid)
        assert client.stats()["steps"] == 4
    finally:
        close()


def _codes(client, bad_opens, good_cad, bad_frames, frame):
    """Status codes of refused opens, of refused steps of one session,
    and of a step of an unknown session."""
    codes = []
    for cad, views in bad_opens:
        try:
            client.close_session(client.open_session(cad, views))
            codes.append(201)
        except SessionError as e:
            codes.append(e.status)
    sid = client.open_session(good_cad)
    for f in bad_frames:
        try:
            client.step(sid, f)
            codes.append(200)
        except SessionError as e:
            codes.append(e.status)
    for f in (frame, frame):
        client.step(sid, f)
    client.close_session(sid)
    try:
        client.step(sid, frame)
    except SessionError as e:
        codes.append(e.status)
    return codes


@pytest.mark.parametrize("kind", ["mux", "single"])
def test_artifact_engines_refuse_as_the_jax_engines(jax_artifact, kind):
    """The same JAX artifact behind the JAX engine and the port's: the
    same status codes for a bad CAD shape or dtype (the single-session
    engines cast the CAD image to uint8, as JAX's does), unexpected views,
    a bad frame shape or dtype, and an unknown session."""
    engines = {"mux": (JaxArtifactMuxEngine, ArtifactMuxEngine),
               "single": (JaxArtifactEngine, ArtifactEngine)}[kind]
    cad = _uint8((32, 32, 3), seed=9)
    frame = _uint8((32, 32, 3), seed=10)
    bad_opens = [(cad[:16], None), (cad.astype(np.float32), None),
                 (cad, _uint8((2, 32, 32, 3), seed=11))]
    bad_frames = [frame[:16], frame.astype(np.int32)]
    codes = []
    for engine, make in ((engines[0](jax_artifact), jax_make_server),
                         (engines[1](jax_artifact, device="cpu"),
                          make_server)):
        client, close = _serve(engine, make)
        try:
            codes.append(_codes(client, bad_opens, cad, bad_frames, frame))
        finally:
            close()
    assert codes[0] == codes[1]
    assert codes[1] == [400, 400 if kind == "mux" else 201, 400, 400, 400,
                        404]
