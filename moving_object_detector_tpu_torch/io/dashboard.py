"""Live in-flight visualization: a tiny embedded HTTP dashboard (the JAX
package's ``io/dashboard.py``).

The reference ships interactive rqt/rviz dashboards a human watches while
the pipeline runs (moving_object_detector_launch/rqt/
detection_images.perspective: left/depth/cluster image topics;
rviz/gazebo_simulation.rviz:88-132: marker displays). This module is the
single-process analog for ``run.py --serve-port``: a stdlib
ThreadingHTTPServer on a daemon thread serving

* ``/``            — auto-refreshing HTML page (camera + detections
                     overlay, cluster labels, optical flow, depth,
                     editable tunables panel),
* ``/view/<name>.png`` — the latest rendered product,
* ``/status.json`` — frame counter, timestamps, detection/track tallies,
                     throughput estimate,
* ``/tunables.json``   — current hot-tunable values (GET),
* ``/tunables`` (POST) — queue tunable updates; the runner applies them
                     between frames via Tunables.replace_values — the
                     full dynamic_reconfigure loop (observe AND adjust
                     in one pane, like rqt reconfigure over
                     Clusterer.cfg / MovingObjectTracker.cfg),
* ``/sim`` (POST)      — steer an InteractiveSceneSequence (io/scenes.py)
                     when one is attached (set_sim_handler): WASD/QE
                     drive the camera, arrow keys the object — the
                     Gazebo joystick-parity loop (README.md:54-68).

Rendering happens on the harvest path (one frame behind the device, like
the file exports) on the host copy the runner fetches there: ``update``
touches no tensor, so it adds no launch and no device sync. The runner
fetches, and ``update`` encodes, only the products a browser asked for
recently (``wanted``: "compute-on-demand observability" — the
reference's getNumSubscribers() gating, clusterer_nodelet.cpp:233-238).

Zero external dependencies: PNGs come from viz.png_bytes.
"""

from __future__ import annotations

import json
import threading
import time
from types import SimpleNamespace

import numpy as np

from . import viz

_PAGE = """<!DOCTYPE html>
<html><head><title>moving_object_detector_tpu_torch live</title>
<style>
 body {{ background: #111; color: #ddd; font-family: monospace; }}
 img {{ image-rendering: pixelated; max-width: 48vw; border: 1px solid #444; }}
 .grid {{ display: flex; flex-wrap: wrap; gap: 8px; }}
 figure {{ margin: 0; }}
 figcaption {{ color: #8bc; padding: 2px; }}
 #status {{ white-space: pre; color: #ac8; }}
</style></head>
<body>
<h3>moving_object_detector_tpu_torch &mdash; live run</h3>
<div id="status">waiting for frames...</div>
<details id="drivebox" style="display:none"><summary style="color:#9ac">
 drive (interactive sim): WASD = camera x/z, Q/E = yaw,
 arrows = object, space = stop</summary>
 <div id="drivestate"></div>
</details>
<details><summary style="color:#c9a">tunables (dynamic_reconfigure)</summary>
 <form id="tunables" onsubmit="return applyTunables(event)">
  <div id="knobs"></div>
  <button type="submit">apply</button>
  <span id="tunmsg"></span>
 </form>
</details>
<div class="grid">
 <figure><figcaption>camera + detections (red) / tracks (green)</figcaption>
   <img id="camera" src="/view/camera.png"></figure>
 <figure><figcaption>clusters (~clusters_image)</figcaption>
   <img id="clusters" src="/view/clusters.png"></figure>
 <figure><figcaption>optical flow</figcaption>
   <img id="flow" src="/view/flow.png"></figure>
 <figure><figcaption>depth (~depth)</figcaption>
   <img id="depth" src="/view/depth.png"></figure>
</div>
<script>
 const imgs = ["camera", "clusters", "flow", "depth"];
 setInterval(() => {{
   const t = Date.now();
   for (const n of imgs) {{
     document.getElementById(n).src = `/view/${{n}}.png?t=${{t}}`;
   }}
   fetch("/status.json").then(r => r.json()).then(s => {{
     document.getElementById("status").textContent =
       JSON.stringify(s, null, 1);
   }}).catch(() => {{}});
 }}, {refresh_ms});
 function loadTunables() {{
   fetch("/tunables.json").then(r => r.json()).then(t => {{
     const div = document.getElementById("knobs");
     div.innerHTML = "";
     for (const [k, v] of Object.entries(t)) {{
       const row = document.createElement("label");
       row.style.display = "block";
       row.textContent = k + " ";
       const inp = document.createElement("input");
       inp.name = k; inp.value = v; inp.size = 10;
       row.appendChild(inp);
       div.appendChild(row);
     }}
   }}).catch(() => setTimeout(loadTunables, 2000));
 }}
 loadTunables();
 function applyTunables(ev) {{
   ev.preventDefault();
   const vals = {{}};
   for (const inp of document.querySelectorAll("#knobs input")) {{
     const x = parseFloat(inp.value);
     if (!Number.isNaN(x)) vals[inp.name] = x;
   }}
   fetch("/tunables", {{method: "POST", body: JSON.stringify(vals)}})
     .then(r => r.json())
     .then(s => document.getElementById("tunmsg").textContent =
                  JSON.stringify(s))
     .catch(e => document.getElementById("tunmsg").textContent = e);
   return false;
 }}
 // Interactive-sim driving (the Gazebo joystick analog): hold a key to
 // command a velocity, release to stop that axis. 409 = no sim attached
 // (panel stays hidden).
 const CAM_V = 1.0, YAW_V = 0.3, OBJ_V = 1.5;
 let simCmd = {{cam_velocity: [0, 0, 0], yaw_rate: 0,
               obj_velocity: [[0, 0, 0]]}};
 function simPost() {{
   fetch("/sim", {{method: "POST", body: JSON.stringify(simCmd)}})
     .then(r => {{
       if (r.status === 409) return null;
       document.getElementById("drivebox").style.display = "";
       return r.json();
     }})
     .then(s => {{ if (s) document.getElementById("drivestate").textContent
                    = JSON.stringify(s); }})
     .catch(() => {{}});
 }}
 simPost();  // probe once: reveals the panel when a sim is attached
 const KEYMAP = {{
   w: ["cam", 2, CAM_V], s: ["cam", 2, -CAM_V],
   a: ["cam", 0, -CAM_V], d: ["cam", 0, CAM_V],
   q: ["yaw", 0, -YAW_V], e: ["yaw", 0, YAW_V],
   ArrowRight: ["obj", 0, OBJ_V], ArrowLeft: ["obj", 0, -OBJ_V],
   ArrowUp: ["obj", 2, OBJ_V], ArrowDown: ["obj", 2, -OBJ_V],
 }};
 function simKey(ev, down) {{
   if (ev.target.tagName === "INPUT") return;
   if (ev.key === " " && down) {{
     simCmd = {{cam_velocity: [0, 0, 0], yaw_rate: 0,
               obj_velocity: [[0, 0, 0]]}};
     simPost(); ev.preventDefault(); return;
   }}
   const m = KEYMAP[ev.key];
   if (!m) return;
   const v = down ? m[2] : 0;
   if (m[0] === "cam") simCmd.cam_velocity[m[1]] = v;
   else if (m[0] === "yaw") simCmd.yaw_rate = v;
   else simCmd.obj_velocity[0][m[1]] = v;
   simPost(); ev.preventDefault();
 }}
 document.addEventListener("keydown", ev => simKey(ev, true));
 document.addEventListener("keyup", ev => simKey(ev, false));
</script>
</body></html>
"""


def _draw_rect(img: np.ndarray, y0, x0, y1, x1, color, thick=2):
    h, w = img.shape[:2]
    y0, y1 = sorted((int(y0), int(y1)))
    x0, x1 = sorted((int(x0), int(x1)))
    y0c, y1c = max(y0, 0), min(y1, h - 1)
    x0c, x1c = max(x0, 0), min(x1, w - 1)
    if y1c < 0 or x1c < 0 or y0c >= h or x0c >= w or y1c < y0c or x1c < x0c:
        return
    for t in range(thick):
        for yy in (y0 + t, y1 - t):
            if 0 <= yy < h:
                img[yy, x0c : x1c + 1] = color
        for xx in (x0 + t, x1 - t):
            if 0 <= xx < w:
                img[y0c : y1c + 1, xx] = color


def _draw_line(img: np.ndarray, y0, x0, y1, x1, color):
    h, w = img.shape[:2]
    n = int(max(abs(y1 - y0), abs(x1 - x0), 1)) + 1
    ys = np.linspace(y0, y1, n).round().astype(int)
    xs = np.linspace(x0, x1, n).round().astype(int)
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[ok], xs[ok]] = color


def _overlay_objects(img, objects, cam, color, arrow_s=0.5):
    """Draw projected bounding boxes + velocity arrows for a MovingObjects
    batch (moving_object_to_marker:51-108 CUBE+ARROW semantics, rendered
    into the camera view instead of rviz 3D)."""
    valid = np.asarray(objects.valid)
    centers = np.asarray(objects.center)
    bboxes = np.asarray(objects.bounding_box)
    vels = np.asarray(objects.velocity)
    for i in np.flatnonzero(valid):
        x, y, z = centers[i]
        # Skip what lies behind the camera or is not finite.
        if not (z > 0.1 and np.isfinite(centers[i]).all()
                and np.isfinite(bboxes[i]).all()):
            continue
        u = cam.fx * x / z + cam.cx
        v = cam.fy * y / z + cam.cy
        hw = cam.fx * (bboxes[i, 0] / 2.0) / z
        hh = cam.fy * (bboxes[i, 1] / 2.0) / z
        _draw_rect(img, v - hh, u - hw, v + hh, u + hw, color)
        # Arrow: center -> center + velocity * arrow_s seconds.
        xe, ye, ze = centers[i] + vels[i] * arrow_s
        if ze > 0.1 and np.isfinite(vels[i]).all():
            ue = cam.fx * xe / ze + cam.cx
            ve = cam.fy * ye / ze + cam.cy
            _draw_line(img, v, u, ve, ue, color)


class LiveDashboard:
    """Embedded HTTP viewer. ``update()`` is called from the runner's
    harvest path; product PNGs are (re)encoded only when a browser
    requested that product within the last ``demand_window`` seconds."""

    PRODUCTS = ("camera", "clusters", "flow", "depth")
    # The frame-output fields each product is drawn from, besides the
    # detections and tracks every frame's status reads.
    FIELDS = {"camera": ("odom_pose",), "clusters": ("label_image",),
              "flow": ("flow",), "depth": ("scene_flow",)}

    def __init__(self, port: int, host: str = "0.0.0.0",
                 refresh_ms: int = 500, demand_window: float = 5.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self._lock = threading.Lock()
        self._pngs: dict[str, bytes] = {}
        self._status: dict = {"frames": 0}
        self._demand: dict[str, float] = {p: 0.0 for p in self.PRODUCTS}
        self._t_first = None
        self.demand_window = demand_window
        # Retune channel: POSTed knob values queue here; the runner pops
        # them between frames (Tunables.replace_values). The view dict is
        # the runner-pushed current values served at /tunables.json.
        self._pending_tunables: dict = {}
        self._tunables_view: dict = {}
        # Interactive-sim steering: POST /sim forwards to this handler
        # (InteractiveSceneSequence.command — itself thread-safe).
        self._sim_handler = None
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet server
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path in ("/", "/index.html"):
                    body = _PAGE.format(refresh_ms=refresh_ms).encode()
                    self._send(200, "text/html", body)
                elif path == "/status.json":
                    with dash._lock:
                        body = json.dumps(dash._status).encode()
                    self._send(200, "application/json", body)
                elif path == "/tunables.json":
                    with dash._lock:
                        body = json.dumps(dash._tunables_view).encode()
                    self._send(200, "application/json", body)
                elif path.startswith("/view/") and path.endswith(".png"):
                    name = path[len("/view/"):-len(".png")]
                    with dash._lock:
                        dash._demand[name] = time.time()
                        body = dash._pngs.get(name)
                    if body is None:
                        self._send(404, "text/plain", b"not rendered yet")
                    else:
                        self._send(200, "image/png", body)
                else:
                    self._send(404, "text/plain", b"unknown path")

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                if path not in ("/tunables", "/sim"):
                    self._send(404, "text/plain", b"unknown path")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    values = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(values, dict):
                        raise ValueError("body must be a JSON object")
                except (ValueError, OSError) as e:
                    self._send(400, "application/json",
                               json.dumps({"error": str(e)}).encode())
                    return
                if path == "/sim":
                    handler = dash._sim_handler
                    if handler is None:
                        self._send(409, "application/json",
                                   b'{"error": "no interactive sim"}')
                        return
                    try:
                        state = handler(**values)
                    except (TypeError, ValueError) as e:
                        self._send(400, "application/json",
                                   json.dumps({"error": str(e)}).encode())
                        return
                    self._send(200, "application/json",
                               json.dumps(state).encode())
                    return
                with dash._lock:
                    dash._pending_tunables.update(values)
                self._send(200, "application/json",
                           json.dumps({"queued": sorted(values)}).encode())

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def set_sim_handler(self, handler) -> None:
        """Attach an interactive-scene command callback (POST /sim)."""
        self._sim_handler = handler

    def pop_pending_tunables(self) -> dict:
        """Drain queued retune values (runner, between frames)."""
        with self._lock:
            pending, self._pending_tunables = self._pending_tunables, {}
        return pending

    def set_tunables_view(self, values: dict) -> None:
        """Publish the current tunable values for /tunables.json."""
        with self._lock:
            self._tunables_view = dict(values)

    def _wanted(self, name: str) -> bool:
        # Never-rendered products are always rendered (the first frame can
        # arrive long after the page load, behind the kernels' build and
        # the weights' load, when the demand window has expired);
        # afterwards, only on recent demand.
        if name not in self._pngs:
            return True
        return time.time() - self._demand[name] < self.demand_window

    def wanted(self) -> tuple:
        """The products to render now."""
        with self._lock:
            return tuple(p for p in self.PRODUCTS if self._wanted(p))

    def wanted_fields(self) -> set:
        """The frame-output fields the wanted products read: the runner
        fetches them to the host with the frame's results."""
        return {f for p in self.wanted() for f in self.FIELDS[p]}

    def update(self, index: int, t: float, out, left, config, stereo):
        """Render + publish the latest frame's products (runner harvest
        path, one frame behind the device). ``out`` is the runner's host
        copy of the frame's outputs (numpy arrays; the fields of products
        not fetched are None), ``stereo`` its host copy of the rig."""
        now = time.time()
        if self._t_first is None:
            self._t_first = (now, index)
        n_det = int(np.asarray(out.detections.valid).sum())
        n_trk = int(np.asarray(out.tracked.objects.valid).sum())
        t0, k0 = self._t_first
        fps = (index - k0) / (now - t0) if now > t0 and index > k0 else 0.0
        todo = [p for p in self.wanted()
                if all(getattr(out, f) is not None for f in self.FIELDS[p])]
        pngs = {}
        # Camera overlay is the headline view: render it whenever anything
        # is wanted (the first page load requests all four).
        if "camera" in todo:
            img = np.asarray(left, np.float32)
            if img.max() > 1.5:
                img = img / 255.0
            if img.ndim == 3:  # color frames render natively
                rgb = np.clip(img[..., :3], 0, 1).copy()
            else:
                rgb = np.repeat(np.clip(img, 0, 1)[..., None], 3, axis=-1)
            _overlay_objects(rgb, out.detections, stereo.cam, (1.0, 0.2, 0.2))
            # Tracks live in the odom frame; draw them through the camera
            # pose (odom <- camera).
            try:
                inv = np.linalg.inv(np.asarray(out.odom_pose, np.float64))
            except np.linalg.LinAlgError:
                inv = None  # singular pose: skip the track overlay
            if inv is not None:
                trk = out.tracked.objects
                tracks = SimpleNamespace(
                    valid=trk.valid, bounding_box=trk.bounding_box,
                    center=np.asarray(trk.center) @ inv[:3, :3].T
                    + inv[:3, 3],
                    velocity=np.asarray(trk.velocity) @ inv[:3, :3].T)
                _overlay_objects(rgb, tracks, stereo.cam, (0.2, 1.0, 0.2))
            pngs["camera"] = viz.png_bytes(rgb)
        if "clusters" in todo:
            pngs["clusters"] = viz.png_bytes(
                viz.colorize_labels(
                    np.asarray(out.label_image),
                    config.clusterer.max_objects,
                )
            )
        if "flow" in todo:
            pngs["flow"] = viz.png_bytes(
                viz.flow_to_rgb(np.asarray(out.flow))
            )
        if "depth" in todo:
            pngs["depth"] = viz.png_bytes(
                viz.depth_image(np.asarray(out.scene_flow.points))
            )
        status = {
            "frame": index,
            "stream_time": round(float(t), 3),
            "detections": n_det,
            "tracks": n_trk,
            "ego_success": bool(out.ego_success),
            "frame_valid": bool(out.frame_valid),
            "throughput_fps": round(fps, 2),
        }
        with self._lock:
            self._pngs.update(pngs)
            self._status = status

    def close(self):
        self._server.shutdown()
        self._server.server_close()
