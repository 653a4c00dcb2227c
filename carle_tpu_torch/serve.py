"""Serving daemon: score agents and evolve patterns on demand (counterpart of
carle_tpu/serve.py).

A dependency-free HTTP daemon (stdlib ``http.server``), one request at a
time, in front of the scoring battery, the packed multi-step engine and the
pattern analytics.

Endpoints (JSON in/out):

  GET  /           a browser demo page that drives /gif and /classify
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
  POST /gif        the /rollout inputs plus "every" (frame stride, default
                   4), "fps", "scale"
                   -> {"rule", "generations", "frames", "population",
                       "gif_base64" (GIF89a), "latency_s"}; a frame every
                       ``every`` generations of the packed engine
  POST /classify   the /rollout pattern inputs plus "max_period" (default 64)
                   -> {"kind", "period", "displacement", "population",
                       "speed", "latency_s"}; with "census": true
                       {"objects", "counts", "latency_s"} instead
                       (analysis.py: the ``ca_step`` kernel on the card)

``"network"`` scores the frozen random CNN (``RandomNetworkAgent``), its
weights from ``params_path`` (``.pt`` or ``.npz``) when given; ``"policy"``
the shipped trained PPO policy (``evaluation.eval.load_shipped_policy``), or
the native ``.npz`` params at ``params_path``, loaded once a path and device.
A soup (no ``"rle"``) is drawn from a torch generator seeded by ``"seed"``.

Run:  python -m carle_tpu_torch.serve --port 8787 [--device cpu]
"""

from __future__ import annotations

import base64
import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import rules as rules_mod
from .agents import RandomNetworkAgent
from .analysis import census, classify_pattern
from .device import DeviceLike, resolve_device
from .evaluation.eval import (DEFAULT_RULES, evaluate_fused, evaluate_fused_batched,
                              load_shipped_policy)
from .ops.bitpack import pack_grid, unpack_grid
from .ops.cuda_bitpack import bit_multi_step
from .rle import encode_grid, parse_rle_text
from .utils.gif import encode_gif


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


def _gif(body: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """The evolution of a soup or an RLE as an animated GIF: a frame every
    ``every`` generations of the packed engine (the remainder run last, so
    /gif ends where /rollout would), the frames collected on the device and
    copied to the host once."""
    steps = int(body.get("steps", 256))
    every = max(1, int(body.get("every", 4)))
    grid, bits, _, _ = _initial_grid(body, device)
    t0 = time.perf_counter()
    w = grid.shape[2]
    packed = pack_grid(grid)
    frames = [grid[0]]
    for k in [every] * (steps // every) + ([steps % every] if steps % every else []):
        packed = bit_multi_step(packed, bits, k)
        frames.append(unpack_grid(packed, w)[0])
    host = torch.stack(frames).cpu().numpy()
    data = encode_gif(host, fps=float(body.get("fps", 20.0)),
                      scale=int(body.get("scale", 1)))
    return {
        "rule": rules_mod.rulestring(*rules_mod.unpack_rule_bits(int(bits))),
        "generations": steps,
        "frames": len(frames),
        "population": int(host[-1].sum()),
        "gif_base64": base64.b64encode(data).decode("ascii"),
        "latency_s": round(time.perf_counter() - t0, 4),
    }


def _classify(body: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Exact (period, displacement) classification of a pattern (the
    /rollout pattern inputs; ``max_period``, default 64), or with
    ``census`` the per-object census."""
    grid, bits, _, _ = _initial_grid(body, device)
    max_period = int(body.get("max_period", 64))
    t0 = time.perf_counter()
    if body.get("census"):
        rep = census(grid[0], bits, max_period=max_period, device=device)
        rep["latency_s"] = round(time.perf_counter() - t0, 4)
        return rep
    c = classify_pattern(grid[0], bits, max_period=max_period, device=device)
    return {
        "kind": c.kind,
        "period": c.period,
        "displacement": list(c.displacement),
        "population": c.population,
        "speed": c.speed,
        "latency_s": round(time.perf_counter() - t0, 4),
    }


# A browser demo served at GET /: drives the JSON endpoints from a form —
# evolve a soup (or pasted RLE) to an animation, census the ash.
_DEMO_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>carle_tpu_torch</title><style>
body{font-family:monospace;background:#0a0a0e;color:#48dc82;margin:2em}
input,textarea,button{background:#14141c;color:#48dc82;border:1px solid #2a4;
padding:4px;font-family:monospace}img{image-rendering:pixelated;border:1px
solid #2a4;margin-top:1em}pre{color:#9ad}</style></head><body>
<h2>carle_tpu_torch</h2>
<form onsubmit="go(event)">
rule <input id=rule value="B3/S23" size=10>
size <input id=size value=128 size=4>
steps <input id=steps value=256 size=5>
density <input id=density value=0.3 size=4>
seed <input id=seed value=0 size=4>
<button>evolve</button></form>
<p>or paste RLE:</p><textarea id=rle rows=4 cols=60></textarea>
<div id=out></div>
<script>
async function go(e){e.preventDefault();
const body={rule:rule.value,size:+size.value,steps:+steps.value,
density:+density.value,seed:+seed.value,every:4,scale:2};
if(rle.value.trim())body.rle=rle.value;
out.innerHTML="evolving...";
const g=await(await fetch("/gif",{method:"POST",
body:JSON.stringify(body)})).json();
const c=await(await fetch("/classify",{method:"POST",
body:JSON.stringify({...body,census:true})})).json();
out.innerHTML='<img src="data:image/gif;base64,'+g.gif_base64+'">'+
'<pre>population '+g.population+' after '+g.generations+
' generations\\ncensus: '+JSON.stringify(c.counts)+'</pre>';}
</script></body></html>"""


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
        if self.path in ("/", "/index.html"):
            data = _DEMO_PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
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
        routes = {"/score": _score, "/rollout": _rollout, "/gif": _gif,
                  "/classify": _classify}
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
