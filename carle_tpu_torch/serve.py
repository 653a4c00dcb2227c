"""Serving daemon: score agents and evolve patterns on demand (counterpart of
carle_tpu/serve.py:74-219, 331-420).

A dependency-free HTTP daemon (stdlib ``http.server``), one request at a
time, in front of the scoring battery and the packed multi-step engine.

Endpoints (JSON in/out):

  GET  /health     liveness + device + request counters
  POST /score      {"agent": "random"|"network"|"policy", "params_path": str,
                    "steps": int, "seed": int, "seeds": [int, ...],
                    "batched": bool, "toggle_rate": float, "replicas": int,
                    "reference_compat": bool}
                   -> {"score", "per_ruleset", "per_seed" (multi-seed),
                       "latency_s"}
  POST /rollout    {"rule": "B3/S23", "steps": int, "size": int, "seed": int,
                    "density": float, "rle": str|null}
                   -> {"rule", "generations", "population", "rle",
                       "latency_s"}; the generations run through the
                       ``bit_multi_step`` kernel on the card

``"network"`` scores the frozen random CNN (``RandomNetworkAgent``), its
weights from ``params_path`` (``.pt`` or ``.npz``) when given; ``"policy"``
the shipped trained PPO policy (``evaluation.eval.load_shipped_policy``), or
the native ``.npz`` params at ``params_path``, loaded once a path and device.
``/gif`` and ``/classify`` are not ported yet.

Run:  python -m carle_tpu_torch.serve --port 8787 [--device cpu]
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import rules as rules_mod
from .agents import RandomNetworkAgent
from .device import DeviceLike, resolve_device
from .evaluation.eval import (DEFAULT_RULES, evaluate_fused, evaluate_fused_batched,
                              load_shipped_policy)
from .ops.bitpack import pack_grid, unpack_grid
from .ops.cuda_bitpack import bit_multi_step
from .rle import encode_grid, parse_rle_text


# The policy's (Agent, params) pair a params_path and device, so repeated
# /score requests read its 4096 x 4096 dense layer once.
_POLICY_CACHE: Dict[Tuple[Optional[str], torch.device], Tuple[Any, Any]] = {}


def _shipped_policy(params_path: Optional[str], device: torch.device) -> Tuple[Any, Any]:
    pair = _POLICY_CACHE.get((params_path, device))
    if pair is None:
        pair = _POLICY_CACHE[(params_path, device)] = load_shipped_policy(params_path, device)
    return pair


def _score(body: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    agent_kind = body.get("agent", "random")
    params_path = body.get("params_path")
    if agent_kind == "random":
        agent: Any = None
    elif agent_kind == "network":
        agent = RandomNetworkAgent
    elif agent_kind == "policy":
        agent, params_path = _shipped_policy(params_path, device), None
    else:
        raise ValueError(f"unknown agent {agent_kind!r}; one of random/network/policy")
    batched = bool(body.get("batched", True))
    seeds = body.get("seeds") or [int(body.get("seed", 0))]
    kwargs = dict(
        Agent=agent,
        params_path=params_path,
        steps=int(body.get("steps", 1024)),
        toggle_rate=float(body.get("toggle_rate", 0.1)),
        reference_compat=bool(body.get("reference_compat", True)),
        verbose=False,
        device=device,
    )
    if batched:
        kwargs["replicas"] = int(body.get("replicas", 1))
    fn = evaluate_fused_batched if batched else evaluate_fused
    t0 = time.perf_counter()
    scores, per_rules = [], []
    for s in seeds:
        score, per_rule = fn(seed=int(s), **kwargs)
        scores.append(float(score))
        per_rules.append(np.asarray(per_rule, dtype=np.float64).ravel())
    pr = np.mean(per_rules, axis=0)  # seed-averaged
    if not batched:
        # the sequential path returns a per-step trace; reduce it to the
        # per-ruleset mean reward per step, as the batched path reports
        pr = pr.reshape(len(DEFAULT_RULES), -1).mean(axis=1)
    out: Dict[str, Any] = {
        "score": float(np.mean(scores)),
        "agent": agent_kind,
        "steps": kwargs["steps"],
        "batched": batched,
        "per_ruleset": [float(x) for x in pr],
        "latency_s": round(time.perf_counter() - t0, 4),
    }
    if len(seeds) > 1:
        out["per_seed"] = scores
    return out


def _initial_grid(body: Dict[str, Any], device: torch.device):
    """(grid uint8 [1, H, W] with W a multiple of 32, rule bits, birth,
    survive) from a request body: an explicit RLE or a Bernoulli soup."""
    size = int(body.get("size", 256))
    birth, survive = rules_mod.parse_rulestring(body.get("rule", "B3/S23"))
    bits = rules_mod.pack_rule_bits(birth, survive)
    if body.get("rle"):
        pattern = parse_rle_text(body["rle"]).grid
        h = max(size, pattern.shape[0])
        w = -(-max(size, pattern.shape[1]) // 32) * 32  # packed W % 32 == 0
        full = np.zeros((h, w), dtype=np.uint8)
        r0 = (h - pattern.shape[0]) // 2
        c0 = (w - pattern.shape[1]) // 2
        full[r0:r0 + pattern.shape[0], c0:c0 + pattern.shape[1]] = pattern
        grid = torch.from_numpy(full[None]).to(device)
    else:
        w = -(-size // 32) * 32
        gen = torch.Generator(device=device).manual_seed(int(body.get("seed", 0)))
        soup = (torch.rand((1, size, size), generator=gen, device=device)
                < float(body.get("density", 0.3))).to(torch.uint8)
        grid = torch.zeros((1, size, w), dtype=torch.uint8, device=device)
        grid[:, :, (w - size) // 2:(w - size) // 2 + size] = soup
    return grid, bits, birth, survive


def _rollout(body: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    steps = int(body.get("steps", 256))
    grid, bits, birth, survive = _initial_grid(body, device)
    t0 = time.perf_counter()
    out = bit_multi_step(pack_grid(grid), bits, steps)
    final = unpack_grid(out, grid.shape[2])[0].cpu().numpy()
    return {
        "rule": rules_mod.rulestring(birth, survive),
        "generations": steps,
        "population": int(final.sum()),
        "rle": encode_grid(final, birth, survive),
        "latency_s": round(time.perf_counter() - t0, 4),
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "carle_tpu_torch_serve/1.0"

    def log_message(self, fmt, *args):  # quiet unless asked
        if self.server.verbose:
            super().log_message(fmt, *args)

    def _reply(self, code: int, payload: Dict[str, Any]) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path != "/health":
            return self._reply(404, {"error": "unknown path"})
        srv = self.server
        dev = srv.device
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        self._reply(200, {
            "ok": True,
            "device": str(dev),
            "device_name": name,
            "requests": srv.stats["requests"],
            "errors": srv.stats["errors"],
            "uptime_s": round(time.time() - srv.stats["started"], 1),
        })

    def do_POST(self):
        routes = {"/score": _score, "/rollout": _rollout}
        handler = routes.get(self.path)
        if handler is None:
            return self._reply(404, {"error": "unknown path"})
        srv = self.server
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            srv.stats["requests"] += 1
            self._reply(200, handler(body, srv.device))
        except Exception as exc:  # serve errors as JSON, keep the daemon up
            srv.stats["errors"] += 1
            self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})


def make_server(host: str = "127.0.0.1", port: int = 8787,
                device: DeviceLike = None, verbose: bool = False) -> HTTPServer:
    """A server bound to (host, port) whose requests run on ``device``
    (CUDA unless the caller asks for the CPU); call ``serve_forever``."""
    srv = HTTPServer((host, port), _Handler)
    srv.device = resolve_device(device)
    srv.verbose = verbose
    srv.stats = {"requests": 0, "errors": 0, "started": time.time()}
    return srv


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)
    srv = make_server(args.host, args.port, args.device, args.verbose)
    print(json.dumps({"serving": f"http://{args.host}:{args.port}",
                      "device": str(srv.device)}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
