"""Persistent inference server: a warm model behind HTTP/JSON (counterpart
of ``alignn_tpu/cli/serve.py``).

The model directory loads once (:func:`~alignn_tpu_torch.zoo.
load_model_dir`).  Requests are padded into a bucket floor that only grows
(:meth:`ModelService._merge_spec`), and the forward is one
:class:`~alignn_tpu_torch.ff.step_loop.CompiledStep` for the server's
life: a CUDA graph per bucket signature on the card, captured at the third
request of a bucket and replayed after, as JAX keeps one ``jax.jit``.  With
``--ff`` a :class:`~alignn_tpu_torch.ff.calculator.Calculator` of the same
directory serves energy, forces and stress.  One lock serialises the
device work of every request, a capture included.

    python -m alignn_tpu_torch.cli.serve --model_dir out --port 8000 \
        [--ff] [--device cpu]

Endpoints (JSON):
  GET  /health            -> {"status": "ok", "model": ..., "ff": bool}
  POST /predict           {"atoms": {...}} or {"atoms_list": [{...}]}
                          -> {"predictions": [[...], ...]}
  POST /ff                {"atoms": {...}}
                          -> {"energy": e, "forces": [[...]], "stress": [...]}

An unknown path answers 404, a request that fails 400 with
``{"error": "<type>: <message>"}``, as in JAX.  ``atoms`` dicts use the
jarvis schema (lattice_mat / coords / elements / cartesian).  JAX's
persistent compile cache has no counterpart: the CUDA kernels are built
once into ``build/``.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List

import numpy as np
import torch

from alignn_tpu_torch import resolve_device
from alignn_tpu_torch.chem.atoms import Atoms
from alignn_tpu_torch.data.loader import worst_case_spec
from alignn_tpu_torch.ff.step_loop import CompiledStep
from alignn_tpu_torch.graph.batch import BucketSpec, batch_graphs
from alignn_tpu_torch.graph.build import build_graph
from alignn_tpu_torch.nn.ealignn import eALIGNNAtomWise, ealignn_forward
from alignn_tpu_torch.nn.models import ALIGNNAtomWise, atomwise_forward
from alignn_tpu_torch.zoo import load_model_dir


class ModelService:
    """The loaded model, its compiled forward and the bucket floor; the
    device work of a request runs under one lock."""

    def __init__(self, model_dir: str, cutoff: float = 8.0,
                 max_neighbors: int = 12, ff: bool = False, device=None):
        self.device = resolve_device(device)
        self.model, self.cfg = load_model_dir(model_dir, self.device)
        self.model_dir = model_dir
        self.cutoff = cutoff
        self.max_neighbors = max_neighbors
        self.atom_features = self.cfg.get("atom_features", "cgcnn")
        self._lock = threading.Lock()
        self._calc = None
        self._spec = None           # the bucket floor
        self.forward = CompiledStep(self._forward, pool_key=self.model)
        if ff:
            from alignn_tpu_torch.ff.calculator import Calculator

            self._calc = Calculator(path=model_dir, device=self.device)

    def _forward(self, batch) -> torch.Tensor:
        """The graph-level output of a batch (a force field's energy)."""
        model = self.model
        if isinstance(model, eALIGNNAtomWise):
            out = ealignn_forward(model, batch)["out"]
        elif isinstance(model, ALIGNNAtomWise):
            out = atomwise_forward(model, batch)["out"]
        else:
            with torch.no_grad():
                out = model(batch)
        return out.detach()

    def _merge_spec(self, spec: BucketSpec) -> BucketSpec:
        """Grow the bucket floor: similar requests reuse one padded shape,
        so the compiled forward captures a bounded number of graphs."""
        if self._spec is not None:
            spec = BucketSpec(
                n_nodes=max(spec.n_nodes, self._spec.n_nodes),
                n_edges=max(spec.n_edges, self._spec.n_edges),
                n_lg_edges=max(spec.n_lg_edges, self._spec.n_lg_edges),
                n_graphs=max(spec.n_graphs, self._spec.n_graphs),
                dense_D=spec.dense_D)
        self._spec = spec
        return spec

    def predict(self, atoms_dicts: List[Dict[str, Any]]) -> List[list]:
        graphs = [build_graph(Atoms.from_dict(d), cutoff=self.cutoff,
                              max_neighbors=self.max_neighbors)
                  for d in atoms_dicts]
        with self._lock:
            spec = self._merge_spec(worst_case_spec(graphs, len(graphs)))
            # no gather windows: the signature is the bucket's alone
            batch = batch_graphs(graphs, spec, self.device,
                                 atom_features=self.atom_features,
                                 gather_windows=False)
            out = self.forward(batch).cpu().numpy()
        return out[:len(graphs)].tolist()

    def ff(self, atoms_dict: Dict[str, Any]) -> Dict[str, Any]:
        if self._calc is None:
            raise ValueError("server started without --ff")
        with self._lock:
            res = self._calc.calculate(Atoms.from_dict(atoms_dict))
        return {"energy": float(res["energy"]),
                "forces": np.asarray(res["forces"]).tolist(),
                "stress": np.asarray(res["stress"]).tolist()}


def make_handler(service: ModelService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", "model": service.model_dir,
                                 "ff": service._calc is not None})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/predict":
                    atoms = req.get("atoms_list") or [req["atoms"]]
                    self._send(200, {"predictions": service.predict(atoms)})
                elif self.path == "/ff":
                    self._send(200, service.ff(req["atoms"]))
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # noqa: BLE001 (errors go back as JSON)
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(model_dir: str, host: str = "127.0.0.1", port: int = 8000,
          cutoff: float = 8.0, max_neighbors: int = 12, ff: bool = False,
          warmup: bool = True, device=None):
    """(server, service): the HTTP server (``port`` 0 picks a free one)
    over a loaded service, not yet serving."""
    service = ModelService(model_dir, cutoff=cutoff,
                           max_neighbors=max_neighbors, ff=ff, device=device)
    if warmup:   # the forward's first eager run before the first request
        probe = {"lattice_mat": (np.eye(3) * 4.0).tolist(),
                 "coords": [[0, 0, 0], [0.5, 0.5, 0.5]],
                 "elements": ["Na", "Cl"]}
        service.predict([probe])
    server = ThreadingHTTPServer((host, port), make_handler(service))
    return server, service


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--cutoff", type=float, default=8.0)
    p.add_argument("--max_neighbors", type=int, default=12)
    p.add_argument("--ff", action="store_true",
                   help="also serve /ff: energy, forces and stress "
                        "(atomwise models)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (cuda or cpu)")
    args = p.parse_args(argv)
    server, _service = serve(args.model_dir, args.host, args.port,
                             args.cutoff, args.max_neighbors, args.ff,
                             device=args.device)
    print(json.dumps({"serving": f"http://{args.host}:"
                                 f"{server.server_address[1]}",
                      "model": args.model_dir}), flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
