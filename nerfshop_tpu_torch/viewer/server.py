"""Minimal web viewer: the editing workflow's verbs as HTTP endpoints over a
port ``Testbed``, and a single-page client (``static/index.html``, a copy of
the JAX package's) with orbit controls.

Counterpart of ``nerfshop_tpu/viewer/server.py``. Endpoints:
  GET  /                 the single-page client
  POST /render           {camera: [3][4], width, height, spp?, exact?,
                         visualize_cameras?, visualize_unit_cube?,
                         visualize_cage?} → PNG
  POST /train            {n_steps?, batch_size?} → {loss, step}
  POST /edit/<verb>      select_sphere, project, grow, compute_proxy,
                         extract_cage, translate, set_cage_vertices,
                         move_vertex, transform_group, membrane, apply,
                         vanish, clear, save_edits
  GET  /state            camera, step, loss, edit stage, cage vertices,
                         loss history, the last rebake's seconds and the
                         last frame's and PNG's milliseconds

A frame is the baked preview (``Testbed.render_interactive``, rebaked when
the network, grid or operators changed) unless ``exact`` is asked for or
there is no network; then ``Testbed.render_dynamic``. The PNG goes through
the port's own encoder. One lock serializes the testbed's users (the
server answers each request on a thread of its own).

Start:  python -m nerfshop_tpu_torch.viewer --scene <dir> [--snapshot a.snap]
or      from nerfshop_tpu_torch.viewer import serve; serve(testbed, port=8080)
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

_STATIC = Path(__file__).parent / "static"


class ViewerServer:
    def __init__(self, testbed, port: int = 8080, bake_resolution: int = 256):
        self.tb = testbed
        self.tb.interactive_bake_resolution = bake_resolution
        self.port = port
        self._lock = threading.Lock()
        self._gs = None  # the GrowingSelection in progress
        self._applied_idx = None  # its operator's slot in the stack, once applied
        #: seconds of the last frame that rebaked (edit or training → frame)
        self.last_rebake_s = None
        #: milliseconds of the last /render: the frame (bake included) and its PNG
        self.last_frame_ms = None
        self.last_png_ms = None

    # ------------------------------------------------------------- handlers

    def render(self, req: dict) -> bytes:
        from nerfshop_tpu_torch.data import image_io

        w = int(req.get("width", 320))
        h = int(req.get("height", 180))
        spp = int(req.get("spp", 1))
        cam = req.get("camera")
        exact = bool(req.get("exact", False))
        with self._lock:
            t0 = time.perf_counter()
            if cam is not None:
                self.tb.camera_matrix = np.asarray(cam, np.float32)
            if exact or self.tb._state is None:
                img = self.tb.render_dynamic(w, h, spp=spp)
            else:
                rebaked = self.tb._baked is None or self.tb._baked_key != self.tb._interactive_key()
                img = self.tb.render_interactive(w, h)
                if rebaked:
                    self.last_rebake_s = time.perf_counter() - t0
            if req.get("visualize_cameras") or req.get("visualize_unit_cube") or req.get("visualize_cage"):
                from nerfshop_tpu_torch.viewer import overlay

                self.tb._gs = self._gs  # the edit in progress (may be None), which the cage overlay draws
                img = overlay.apply_overlays(
                    np.asarray(img), self.tb, np.asarray(self.tb.camera_matrix, np.float32), self.tb._focal_for(w, h),
                    visualize_cameras=bool(req.get("visualize_cameras")),
                    visualize_unit_cube=bool(req.get("visualize_unit_cube")),
                    visualize_cage=bool(req.get("visualize_cage")),
                )
            t1 = time.perf_counter()
            png = image_io.encode_png((np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8))
            self.last_frame_ms = (t1 - t0) * 1e3
            self.last_png_ms = (time.perf_counter() - t1) * 1e3
        return png

    def train(self, req: dict) -> dict:
        with self._lock:
            loss = self.tb.train(int(req.get("n_steps", 16)), int(req.get("batch_size", 1 << 18)))
        return {"loss": float(loss), "step": self.tb.stats.step}

    def state(self) -> dict:
        out = {
            "camera": np.asarray(self.tb.camera_matrix).tolist(),
            "fov_deg": self.tb.fov_deg,
            "step": self.tb.stats.step,
            "loss": self.tb.stats.loss,
            "n_operators": len(self.tb.edit_operators),
            "edit_stage": None if self._gs is None else self._gs.stage.name,
            "last_rebake_s": self.last_rebake_s,
            "last_frame_ms": self.last_frame_ms,
            "last_png_ms": self.last_png_ms,
            "loss_history": [[int(s), float(l)] for s, l in self.tb.loss_history[-256:]],
        }
        gs = self._gs
        if gs is not None and getattr(gs, "cage", None) is not None:
            out["cage_vertices"] = np.asarray(gs.cage.vertices_deformed).tolist()
        return out

    def _reapply(self, tb) -> None:
        """Once the cage in progress is applied, swap the operator of its
        dragged vertices into its slot; the next frame then rebakes."""
        if self._applied_idx is not None and self._applied_idx < len(tb.edit_operators):
            tb.replace_edit_operator(self._applied_idx, self._gs.make_operator())

    def edit(self, verb: str, req: dict) -> dict:
        tb = self.tb
        with self._lock:
            if verb == "select_sphere":
                # the voxels of level 0 inside a world-space sphere
                gs = tb.begin_cage_edit()
                c = np.asarray(req.get("center", [0.5, 0.5, 0.5]), np.float32)
                r = float(req.get("radius", 0.1))
                g = (np.arange(128) + 0.5) / 128
                x, y, z = np.meshgrid(g, g, g, indexing="ij")
                gs.set_selection((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2 < r * r, level=0)
                self._gs = gs
            elif verb == "project":
                # scribble rays through client pixels ([N, 2] in [0, 1]), then grow
                from nerfshop_tpu_torch.ops import rays as rays_lib

                gs = tb.begin_cage_edit()
                w, h = int(req.get("width", 320)), int(req.get("height", 180))

                def t(a):
                    return torch.as_tensor(np.asarray(a, np.float32), device=tb.device)

                pix = np.asarray(req["pixels"], np.float32) * np.asarray([w, h], np.float32)
                bundle = rays_lib.pixel_to_ray(t(pix), t(tb.camera_matrix), t(tb._focal_for(w, h)), t([0.5, 0.5]), t([w, h]))
                n = gs.project(tb.inference_params, tb.grid, bundle.origins, bundle.directions)
                gs.grow_region(tb.grid, int(req.get("growing_steps", 5000)))
                self._gs = gs
                return {"ok": True, "hits": int(n), "stage": gs.stage.name}
            elif verb == "grow":
                self._gs.grow_region(tb.grid, int(req.get("steps", 5000)))
            elif verb == "compute_proxy":
                self._gs.compute_proxy(use_box=bool(req.get("use_box", False)))
            elif verb == "extract_cage":
                self._gs.extract_cage()
            elif verb == "translate":
                self._gs.copy_mode = bool(req.get("copy", False))
                self._gs.translate_cage(np.asarray(req.get("offset", [0, 0, 0]), np.float32))
                self._reapply(tb)
            elif verb == "set_cage_vertices":
                self._gs.set_cage_vertices(np.asarray(req["vertices"], np.float32))
                self._reapply(tb)
            elif verb == "move_vertex":
                v = np.asarray(self._gs.cage.vertices_deformed, np.float32).copy()
                v[int(req["index"])] = np.asarray(req["position"], np.float32)
                self._gs.set_cage_vertices(v)
                self._reapply(tb)
            elif verb == "transform_group":
                # rotate / scale / translate a vertex set (indices or a world box) about its centroid
                self._gs.transform_cage_group(
                    indices=req.get("indices"), box=req.get("box"), rotate_deg=req.get("rotate_deg"),
                    scale=req.get("scale"), offset=req.get("offset"),
                )
                self._reapply(tb)
            elif verb == "membrane":
                # the Poisson membrane of the current deformation (amplitude ≤ 0 clears it),
                # its directions drawn from a generator seeded 5
                amp = float(req.get("amplitude", 1.0))
                if amp <= 0.0:
                    self._gs.clear_membrane()
                else:
                    gen = torch.Generator(device=tb.device)
                    gen.manual_seed(5)
                    self._gs.compute_membrane(tb.inference_params, gen, amplitude=amp, grid=tb.grid)
                self._reapply(tb)
            elif verb == "apply":
                tb.add_edit_operator(self._gs.make_operator())
                self._applied_idx = len(tb.edit_operators) - 1
            elif verb == "vanish":
                tb.grid = self._gs.vanish(tb.grid)
            elif verb == "clear":
                tb.clear_edit_operators()
                self._gs = None
                self._applied_idx = None
            elif verb == "save_edits":
                tb.save_edits(req.get("path", "edits.json"))
            else:
                return {"ok": False, "error": f"unknown verb {verb}"}
        return {"ok": True, "stage": None if self._gs is None else self._gs.stage.name,
                "n_operators": len(tb.edit_operators)}

    # --------------------------------------------------------------- server

    def make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, (_STATIC / "index.html").read_bytes(), "text/html")
                elif self.path == "/state":
                    self._send(200, json.dumps(server_self.state()).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                try:
                    if self.path == "/render":
                        self._send(200, server_self.render(req), "image/png")
                    elif self.path == "/train":
                        self._send(200, json.dumps(server_self.train(req)).encode())
                    elif self.path.startswith("/edit/"):
                        self._send(200, json.dumps(server_self.edit(self.path[len("/edit/"):], req)).encode())
                    else:
                        self._send(404, b"{}")
                except Exception as e:  # the client shows the error
                    self._send(500, json.dumps({"error": f"{type(e).__name__}: {e}"}).encode())

        return Handler

    def serve_forever(self):
        httpd = ThreadingHTTPServer(("0.0.0.0", self.port), self.make_handler())
        print(f"viewer: http://localhost:{self.port}/")
        httpd.serve_forever()

    def start_background(self) -> ThreadingHTTPServer:
        """Serve on 127.0.0.1 from a daemon thread → the server (stop it with
        ``shutdown()`` and ``server_close()``)."""
        httpd = ThreadingHTTPServer(("127.0.0.1", self.port), self.make_handler())
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd


def serve(testbed, port: int = 8080):
    ViewerServer(testbed, port).serve_forever()
