"""Serving runtime: an HTTP decode server with continuous lane batching.

Port of ``videocad_tpu/infer/server.py``. The wire protocol is identical,
so ``ServingClient`` talks to either server:

  GET    /v1/meta                      model/config/capacity info
  GET    /v1/stats                     serving telemetry (ticks, steps,
                                       coalescing factor, tick latency)
  POST   /v1/sessions                  {"cad_image": npy_b64
                                        [, "multiview_images": npy_b64]}
                                       -> {"session_id": ..., "lane": ...}
  POST   /v1/sessions/<id>/step        {"frame": npy_b64}
                                       -> {"step": t, "cmd": c,
                                           "params": [6 masked ints],
                                           "action": [7 normalized floats]}
  DELETE /v1/sessions/<id>             release the lane

:class:`MuxEngine` runs the lane-multiplexed decoder (infer/multiplex.py):
up to ``lanes`` concurrent sessions share one decode step, and a batcher
thread coalesces whatever step requests are queued when the device frees up
into ONE device call (continuous batching), so the per-step decoder weight
stream is paid once per tick, not once per client. Images are base64
``.npy`` payloads. :class:`ArtifactMuxEngine` serves the same lanes from a
``.vcdx`` artifact (``infer/export.py``, the port's or the JAX package's),
:class:`ArtifactEngine` one session at a time from an artifact without
lanes.
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import io
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from videocad_tpu_torch.infer.export import load_exported
from videocad_tpu_torch.infer.multiplex import (close_lane, init_mux_carry,
                                                mux_decode_step, open_lane)
from videocad_tpu_torch.infer.rollout import decode_params
from videocad_tpu_torch.models.videocadformer import GENCAD_IMAGE_SHAPE


def np_to_b64(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr))
    return base64.b64encode(buf.getvalue()).decode("ascii")


def b64_to_np(data: str) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(data)))


class SessionError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def _action_report(t: int, action_row: np.ndarray) -> Dict:
    """The per-step response: denormalized masked action + raw feedback.

    ``action_row`` is the normalized action the engine feeds back (cmd/4,
    params/1000 — actions/ops.py); the integer view is what the agent
    executes in the UI.
    """
    ints = np.rint(action_row * np.asarray([4.0] + [1000.0] * 6)).astype(int)
    return {"step": int(t), "cmd": int(ints[0]),
            "params": [int(v) for v in ints[1:]],
            "action": [float(v) for v in action_row]}


class _LaneEngine:
    """Shared lane-session machinery: session bookkeeping and the
    continuous batcher. Subclasses set ``self._carry`` and provide the two
    device calls, ``_device_open(carry, lane, cad, mv)`` and
    ``_device_step(frames, active, carry)`` (numpy frames and mask).

    All device work happens on the caller threads under ``_lock`` except
    steps, which are queued and coalesced by a batcher thread: every tick
    it drains at most one pending request per lane into a single device
    step call and distributes the per-lane results.
    """

    def __init__(self, lanes: int, seq_len: int, image_size: int,
                 session_ttl_s: Optional[float] = None):
        self.lanes = lanes
        self.seq_len = seq_len
        self.session_ttl_s = session_ttl_s
        self._img = (image_size, image_size, 3)
        self._lock = threading.Lock()          # device calls + carry
        self._smeta: Dict[str, Dict] = {}      # session id -> {lane, t}
        self._free = list(range(lanes))
        self._pending: list = []               # (sid, lane, frame, box)
        self._cv = threading.Condition()
        self._stopping = False
        self._started = time.monotonic()
        self._stats = {"ticks": 0, "steps": 0, "stale_steps": 0,
                       "sessions_opened": 0, "sessions_evicted": 0,
                       "tick_ms_sum": 0.0}
        self._tick_ms = collections.deque(maxlen=512)  # recent, for pcts
        self._batcher = threading.Thread(target=self._batch_loop,
                                         daemon=True)
        self._batcher.start()

    # -- session API --------------------------------------------------
    def _reap_idle_locked(self) -> None:
        """Evict sessions idle past ``session_ttl_s`` (callers hold
        ``_lock``).  Lazy: runs when capacity is requested, so abandoned
        sessions (client crashed mid-episode) can't pin lanes forever.
        Evicted session ids answer 404/410 afterwards — the same contract
        as an explicit close."""
        if self.session_ttl_s is None:
            return
        now = time.monotonic()
        for sid in [s for s, m in self._smeta.items()
                    if now - m["last_used"] > self.session_ttl_s]:
            meta = self._smeta.pop(sid)
            self._carry = close_lane(self._carry, meta["lane"])
            self._free.append(meta["lane"])
            self._stats["sessions_evicted"] += 1

    def open_session(self, cad_image: np.ndarray,
                     multiview_images: Optional[np.ndarray] = None) -> Tuple[str, int]:
        with self._lock:
            if not self._free:
                self._reap_idle_locked()
            if not self._free:
                raise SessionError(
                    503, f"all {self.lanes} lanes busy; retry or raise "
                         "--lanes")
            lane = self._free.pop()
            try:
                self._carry = self._device_open(self._carry, lane,
                                                cad_image, multiview_images)
            except Exception:
                self._free.append(lane)   # bad input must not leak the lane
                raise
            sid = uuid.uuid4().hex[:12]
            self._smeta[sid] = {"lane": lane, "t": 0,
                                "last_used": time.monotonic()}
            self._stats["sessions_opened"] += 1
        return sid, lane

    def step(self, session_id: str, frame: np.ndarray) -> Dict:
        with self._lock:
            meta = self._smeta.get(session_id)
            if meta is None:
                raise SessionError(404, f"unknown session {session_id}")
            if meta["t"] >= self.seq_len:
                raise SessionError(
                    409, f"session exhausted its {self.seq_len}-step "
                         "horizon; open a new session")
            if frame.shape != self._img or frame.dtype != np.uint8:
                raise SessionError(
                    400, f"frame must be uint8 {self._img}, "
                         f"got {frame.dtype} {frame.shape}")
            meta["last_used"] = time.monotonic()
        box = {"event": threading.Event(), "result": None, "error": None}
        with self._cv:
            self._pending.append((session_id, meta["lane"], frame, box))
            self._cv.notify()
        box["event"].wait()
        if box["error"] is not None:
            raise box["error"]
        return box["result"]

    def close_session(self, session_id: str) -> None:
        with self._lock:
            meta = self._smeta.pop(session_id, None)
            if meta is None:
                raise SessionError(404, f"unknown session {session_id}")
            self._carry = close_lane(self._carry, meta["lane"])
            self._free.append(meta["lane"])

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self._batcher.join(timeout=5)

    def stats(self) -> Dict:
        """Serving telemetry: tick counts, coalescing factor, device-tick
        latency (mean over all ticks; p50/p95 over the last 512).  The
        coalescing factor is the continuous batcher's efficiency — steps
        served per device tick, i.e. how many clients shared each decoder
        weight stream."""
        with self._lock:
            s = dict(self._stats)
            recent = sorted(self._tick_ms)
            active = len(self._smeta)
        pct = (lambda q: round(recent[min(len(recent) - 1,
                                          int(q * len(recent)))], 3)
               if recent else None)
        return {
            "uptime_s": round(time.monotonic() - self._started, 1),
            "active_sessions": active,
            "sessions_opened": s["sessions_opened"],
            "sessions_evicted": s["sessions_evicted"],
            "ticks": s["ticks"],
            "steps": s["steps"],
            "stale_steps": s["stale_steps"],
            "coalescing_factor": (round(s["steps"] / s["ticks"], 3)
                                  if s["ticks"] else None),
            "mean_tick_ms": (round(s["tick_ms_sum"] / s["ticks"], 3)
                             if s["ticks"] else None),
            "p50_tick_ms": pct(0.50),
            "p95_tick_ms": pct(0.95),
        }

    # -- continuous batcher -------------------------------------------
    def _batch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait()
                if self._stopping:
                    for *_, box in self._pending:
                        box["error"] = SessionError(503, "server stopping")
                        box["event"].set()
                    return
                # One request per lane per tick; later duplicates for the
                # same lane stay queued for the next tick (a session's
                # steps are inherently serial anyway).
                batch, rest, taken = [], [], set()
                for item in self._pending:
                    if item[1] in taken:
                        rest.append(item)
                    else:
                        taken.add(item[1])
                        batch.append(item)
                self._pending = rest
            self._run_tick(batch)

    def _run_tick(self, batch) -> None:
        """Validate + dispatch one coalesced tick of ``(sid, lane, frame,
        box)`` items and deliver per-item results.

        Validation runs under the engine lock, atomically with the device
        call, and is authoritative for the session step counter: a step
        whose session was closed (or whose lane was re-issued to a new
        session) between queueing and this tick must NOT advance the
        lane's state — without the check, a stale queued frame would
        silently corrupt the replacement session's t=0 carry.  The horizon
        is re-checked here too: two concurrent requests for one session
        can both pass step()'s enqueue-time check at t = seq_len - 1, and
        the deferred duplicate must get the 409, not a device step whose
        clamped cache write would corrupt the final KV slot.
        """
        try:
            live, stale, exhausted = [], [], []
            frames = np.zeros((self.lanes,) + self._img, np.uint8)
            active = np.zeros((self.lanes,), bool)
            with self._lock:
                for sid, lane, frame, box in batch:
                    meta = self._smeta.get(sid)
                    if meta is None or meta["lane"] != lane:
                        stale.append(box)
                        continue
                    if meta["t"] >= self.seq_len:
                        exhausted.append(box)
                        continue
                    live.append((lane, box, meta))
                    frames[lane] = frame
                    active[lane] = True
                if live:
                    t0 = time.monotonic()
                    carry, cmd_logits, param_logits = self._device_step(
                        frames, active, self._carry)
                    self._carry = carry
                    actions = carry["action"].cpu().numpy()  # device sync
                    ts = carry["t"].cpu().numpy()
                    ms = (time.monotonic() - t0) * 1000.0
                    for _, _, meta in live:   # the step is now committed
                        meta["t"] += 1
                    self._stats["ticks"] += 1
                    self._stats["steps"] += len(live)
                    self._stats["tick_ms_sum"] += ms
                    self._tick_ms.append(ms)
                self._stats["stale_steps"] += len(stale)
            for box in stale:
                box["error"] = SessionError(
                    410, "session closed before its step ran")
                box["event"].set()
            for box in exhausted:
                box["error"] = SessionError(
                    409, f"session exhausted its {self.seq_len}-step "
                         "horizon; open a new session")
                box["event"].set()
            for lane, box, _ in live:
                box["result"] = _action_report(ts[lane] - 1, actions[lane])
                box["event"].set()
        except Exception as e:  # deliver, don't kill the batcher
            for *_, box in batch:
                if not box["event"].is_set():
                    box["error"] = e
                    box["event"].set()


class MuxEngine(_LaneEngine):
    """Live-model engine: lane-multiplexed sessions and continuous batching
    on the model's device (the KV caches are updated in place).
    ``weight_quant`` "int8" / "int4" quantizes the decoder once, here."""

    def __init__(self, model, lanes: int = 4, seq_len: int = 187,
                 weight_quant: str = "none",
                 session_ttl_s: Optional[float] = None):
        self.model = model
        self.device = model.device
        self.params = decode_params(model, weight_quant)
        self.weight_quant = weight_quant
        self._carry = init_mux_carry(model, lanes, seq_len,
                                     multiview=model.config.num_views > 0)
        super().__init__(lanes, seq_len, model.config.image_size,
                         session_ttl_s)

    def _session_inputs(self, cad_image, multiview_images):
        """A session's CAD image (1, H, W, C) and multiview images
        (1, V, H, W, C) or None, on the device, checked as the JAX
        server checks them: the CAD image uint8 256 x 256 x 3 under GenCAD
        and frame-sized otherwise; multiview images uint8 (V, H, W, C)
        for a model of V views, refused for a model without views."""
        cfg = self.model.config
        want = (GENCAD_IMAGE_SHAPE if cfg.use_pretrained_cad_model
                else self._img)
        cad = np.asarray(cad_image)
        if cad.shape != want or cad.dtype != np.uint8:
            raise SessionError(400, f"cad_image must be uint8 {want}, "
                                    f"got {cad.dtype} {cad.shape}")
        mv = None
        if cfg.num_views > 0:
            if multiview_images is None:
                raise SessionError(
                    400, f"model expects {cfg.num_views} multiview_images")
            mv = np.asarray(multiview_images)
            mv_want = (cfg.num_views,) + self._img
            if mv.shape != mv_want or mv.dtype != np.uint8:
                raise SessionError(
                    400, f"multiview_images must be uint8 {mv_want}, "
                         f"got {mv.dtype} {mv.shape}")
            mv = torch.from_numpy(mv).to(self.device)[None]
        elif multiview_images is not None:
            raise SessionError(400, "model takes no multiview_images")
        return torch.from_numpy(cad).to(self.device)[None], mv

    def _device_open(self, carry, lane, cad_image, multiview_images):
        return open_lane(self.model, carry, lane,
                         *self._session_inputs(cad_image, multiview_images))

    def _device_step(self, frames, active, carry):
        return mux_decode_step(self.model, self.params,
                               torch.from_numpy(frames).to(self.device),
                               torch.from_numpy(active).to(self.device),
                               carry)

    def meta(self) -> Dict:
        return {"engine": "mux", "lanes": self.lanes,
                "free_lanes": len(self._free), "seq_len": self.seq_len,
                "image_size": self._img[0],
                "weight_quant": self.weight_quant,
                "device": str(self.device),
                "config": dataclasses.asdict(self.model.config)}


class ArtifactMuxEngine(_LaneEngine):
    """Multi-session serving from a ``.vcdx`` artifact exported with
    ``lanes`` (``infer/export.py``): the continuous batching of
    :class:`MuxEngine` over the artifact's :class:`ExportedModel`, with its
    ``weight_quant``. Artifacts without lanes serve through
    :class:`ArtifactEngine`."""

    def __init__(self, path: str, device="cuda",
                 session_ttl_s: Optional[float] = None):
        self.exported = load_exported(path, device)
        if not self.exported.lanes:
            raise ValueError(
                f"{path} has no mux serving lanes; re-export with --lanes N "
                "(cli/export_model.py) or serve it through ArtifactEngine")
        self.device = self.exported.device
        self._carry = self.exported.mux_init()
        super().__init__(self.exported.lanes, self.exported.bucket_len,
                         self.exported.img[0], session_ttl_s)

    def _device_open(self, carry, lane, cad_image, multiview_images):
        want = self.exported.cad_hw
        cad = np.asarray(cad_image)
        if cad.shape != want or cad.dtype != np.uint8:
            raise SessionError(400, f"cad_image must be uint8 {want}, "
                                    f"got {cad.dtype} {cad.shape}")
        if self.exported.multiview:
            if multiview_images is None:
                raise SessionError(400, "this artifact was exported for a "
                                        "multiview model; multiview_images "
                                        "is required")
            return self.exported.mux_open(carry, lane, cad[None],
                                          np.asarray(multiview_images)[None])
        if multiview_images is not None:
            raise SessionError(400, "artifact was exported without "
                                    "multiview inputs")
        return self.exported.mux_open(carry, lane, cad[None])

    def _device_step(self, frames, active, carry):
        return self.exported.mux_step(frames, active, carry)

    def meta(self) -> Dict:
        return {"engine": "artifact-mux", "lanes": self.lanes,
                "free_lanes": len(self._free), "seq_len": self.seq_len,
                "image_size": self._img[0],
                "weight_quant": self.exported.weight_quant,
                "device": str(self.device),
                "config": self.exported.config}


class ArtifactEngine:
    """A ``.vcdx`` artifact without lanes: the decode pair shares one step
    counter across the artifact's batch rows, so this engine serves ONE
    session at a time (as the JAX ArtifactEngine)."""

    def __init__(self, path: str, device="cuda"):
        self.exported = load_exported(path, device)
        if not self.exported.meta.get("has_decode"):
            raise ValueError(
                f"{path} has no incremental decode (exported from a model "
                "without action feedback)")
        self.device = self.exported.device
        self.batch = self.exported.batch
        self.seq_len = self.exported.bucket_len
        self._img = self.exported.img
        self._cad_hw = self.exported.cad_hw
        self._lock = threading.Lock()
        self._session = None   # {id, carry, t}
        self._started = time.monotonic()
        self._stats = {"steps": 0, "sessions_opened": 0, "step_ms_sum": 0.0}

    def meta(self) -> Dict:
        return {"engine": "artifact", "lanes": 1,
                "free_lanes": 0 if self._session else 1,
                "seq_len": self.seq_len, "batch_size": self.batch,
                "image_size": self._img[0],
                "weight_quant": self.exported.weight_quant,
                "device": str(self.device),
                "config": self.exported.config}

    def open_session(self, cad_image: np.ndarray,
                     multiview_images=None) -> Tuple[str, int]:
        cad = np.asarray(cad_image)
        if cad.shape == self._cad_hw:    # one image -> the artifact's batch
            cad = np.broadcast_to(cad, (self.batch,) + self._cad_hw)
        if cad.shape != (self.batch,) + self._cad_hw:
            raise SessionError(400, f"cad_image must be {self._cad_hw} or "
                                    f"{(self.batch,) + self._cad_hw}")
        mv = None
        if self.exported.multiview:
            mv_hw = (self.exported.meta["num_views"],) + self._img
            if multiview_images is None:
                raise SessionError(
                    400, f"this artifact serves a multiview model: "
                         f"multiview_images (uint8 {mv_hw}) is required")
            mv = np.asarray(multiview_images)
            if mv.shape == mv_hw:
                mv = np.broadcast_to(mv, (self.batch,) + mv_hw)
            if mv.shape != (self.batch,) + mv_hw or mv.dtype != np.uint8:
                raise SessionError(
                    400, f"multiview_images must be uint8 {mv_hw} or "
                         f"{(self.batch,) + mv_hw}, got {mv.dtype} "
                         f"{mv.shape}")
            mv = np.array(mv)
        elif multiview_images is not None:
            raise SessionError(400, "artifact was exported without "
                                    "multiview inputs")
        with self._lock:
            if self._session is not None:
                raise SessionError(
                    503, "artifact engine serves one session at a time "
                         "(batch-lockstep decode); close the active "
                         "session or serve an artifact with lanes")
            carry = self.exported.decode_init(cad.astype(np.uint8), mv)
            sid = uuid.uuid4().hex[:12]
            self._session = {"id": sid, "carry": carry, "t": 0}
            self._stats["sessions_opened"] += 1
        return sid, 0

    def step(self, session_id: str, frame: np.ndarray) -> Dict:
        with self._lock:
            s = self._session
            if s is None or s["id"] != session_id:
                raise SessionError(404, f"unknown session {session_id}")
            if s["t"] >= self.seq_len:
                raise SessionError(409, "session exhausted its horizon")
            f = np.asarray(frame)
            if f.shape == self._img:
                f = np.broadcast_to(f, (self.batch,) + self._img)
            if f.shape != (self.batch,) + self._img or f.dtype != np.uint8:
                raise SessionError(400, f"frame must be uint8 {self._img} "
                                        f"or {(self.batch,) + self._img}")
            t0 = time.monotonic()
            carry, _, _ = self.exported.decode_step(np.array(f), s["carry"])
            s["carry"] = carry
            s["t"] += 1
            action = carry["action"][0].cpu().numpy()   # device sync
            self._stats["steps"] += 1
            self._stats["step_ms_sum"] += (time.monotonic() - t0) * 1000.0
            return _action_report(s["t"] - 1, action)

    def close_session(self, session_id: str) -> None:
        with self._lock:
            if self._session is None or self._session["id"] != session_id:
                raise SessionError(404, f"unknown session {session_id}")
            self._session = None

    def stats(self) -> Dict:
        with self._lock:
            s = dict(self._stats)
            active = 1 if self._session else 0
        return {
            "uptime_s": round(time.monotonic() - self._started, 1),
            "active_sessions": active,
            "sessions_opened": s["sessions_opened"],
            "steps": s["steps"],
            "mean_step_ms": (round(s["step_ms_sum"] / s["steps"], 3)
                             if s["steps"] else None),
        }

    def stop(self) -> None:
        pass


class _Handler(BaseHTTPRequestHandler):
    engine = None            # set by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):   # quiet; the CLI logs lifecycle events
        pass

    def _json(self, status: int, payload: Dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> Dict:
        length = int(self.headers.get("Content-Length", 0))
        if not length:
            return {}
        return json.loads(self.rfile.read(length))

    def _route(self, method: str) -> None:
        parts = [p for p in self.path.split("/") if p]
        try:
            if method == "GET" and parts == ["v1", "meta"]:
                return self._json(200, self.engine.meta())
            if method == "GET" and parts == ["v1", "stats"]:
                return self._json(200, self.engine.stats())
            if method == "POST" and parts == ["v1", "sessions"]:
                body = self._body()
                mv = body.get("multiview_images")
                sid, lane = self.engine.open_session(
                    b64_to_np(body["cad_image"]),
                    b64_to_np(mv) if mv else None)
                return self._json(201, {"session_id": sid, "lane": lane})
            if (method == "POST" and len(parts) == 4
                    and parts[:2] == ["v1", "sessions"]
                    and parts[3] == "step"):
                result = self.engine.step(parts[2],
                                          b64_to_np(self._body()["frame"]))
                return self._json(200, result)
            if (method == "DELETE" and len(parts) == 3
                    and parts[:2] == ["v1", "sessions"]):
                self.engine.close_session(parts[2])
                return self._json(200, {"closed": parts[2]})
            return self._json(404, {"error": f"no route {method} {self.path}"})
        except SessionError as e:
            return self._json(e.status, {"error": str(e)})
        except (KeyError, ValueError) as e:
            return self._json(400, {"error": f"bad request: {e}"})

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")


def make_server(engine, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind an HTTP server around ``engine`` (port 0 = ephemeral); caller
    runs ``serve_forever`` (the CLI) or a daemon thread (tests)."""
    handler = type("BoundHandler", (_Handler,), {"engine": engine})
    return ThreadingHTTPServer((host, port), handler)


class ServingClient:
    """Minimal stdlib client for the serving API (used by tests and as the
    reference protocol implementation for agent integrations)."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")

    def _request(self, method: str, path: str, payload: Optional[Dict] = None):
        import urllib.error
        import urllib.request

        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            raise SessionError(e.code, json.loads(e.read())["error"])

    def meta(self) -> Dict:
        return self._request("GET", "/v1/meta")

    def stats(self) -> Dict:
        return self._request("GET", "/v1/stats")

    def open_session(self, cad_image: np.ndarray,
                     multiview_images: Optional[np.ndarray] = None) -> str:
        payload = {"cad_image": np_to_b64(cad_image)}
        if multiview_images is not None:
            payload["multiview_images"] = np_to_b64(multiview_images)
        return self._request("POST", "/v1/sessions", payload)["session_id"]

    def step(self, session_id: str, frame: np.ndarray) -> Dict:
        return self._request("POST", f"/v1/sessions/{session_id}/step",
                             {"frame": np_to_b64(frame)})

    def close_session(self, session_id: str) -> Dict:
        return self._request("DELETE", f"/v1/sessions/{session_id}")
