"""Interactive frame server — the browser-canvas analogue
(flexlight_tpu/serve.py on the port).

The reference's user surface is a live canvas with a pointer-lock WASD
fly camera (`exampleLoader.html` + `modules/io.js`); this build renders
on a headless card host, so the canvas is served over HTTP instead:

- ``GET /``           a small viewer page: <img> refresh loop, WASD
                      key handlers and drag-to-look, all posting to /input,
                      plus the live quality-knob form (the reference's
                      exampleLoader.html:30-75 parameter form)
- ``GET /frame.png``  the most recent rendered frame (PNG), its number
                      in the ``X-Frame-Seq`` header
- ``POST /input``     ``{"type": "keydown"|"keyup", "code": "KeyW"}`` or
                      ``{"type": "mouse", "dx": .., "dy": ..}`` — routed
                      into the engine's WebIo (same key/axis map and
                      integration math as io.js)
- ``GET /config``     current quality knobs (Config + renderer + api)
- ``POST /config``    mutate knobs live: ``{"filter": true,
                      "max_reflections": 3, "renderer": "rasterizer"}``.
                      Applied between frames on the render thread; the
                      renderer re-prepares on change, like the
                      reference's parameterForm handler (loader.js:65-93),
                      and the change persists via utils.settings (the
                      localStorage analogue) when `_persist_settings` is on.
- ``GET /stats``      fps + structured per-frame metrics JSON

One render thread owns the device (frames are rendered continuously,
honoring ``renderer.fps_limit``); HTTP handlers only swap the latest PNG
bytes and mutate IO state, so the device is never touched concurrently.

The render thread deflates each frame's PNG in row parts on the server's
thread pool (utils.image.png_bytes_parts; as many parts as the frame's
height and the process's CPUs allow, utils.image.png_parts) and publishes
the frame when its PNG is whole.

Traced (utils.timing: while a torch profiler records), the render
thread's PNG encode of a frame is the span fl.serve.encode {seq, parts},
and a handler's send of it fl.serve.send {seq}.

Usage:
    server = FrameServer(engine, port=8764)
    url = server.start()          # returns e.g. http://127.0.0.1:8764/
    ...
    server.stop()

CLI: ``python -m flexlight_tpu_torch.serve <scene> [port] [size]
[--device cuda|cpu]`` serves a scene of flexlight_tpu_torch.scenes
(default cornell, 256 x 256) on the device named (default cuda; nothing
probes for a card).
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .utils.image import MAX_PNG_PARTS, png_bytes_parts, png_parts
from .utils.timing import span

_VIEWER_HTML = """<!doctype html>
<html><head><title>flexlight_tpu</title><style>
  body { margin: 0; background: #111; color: #ddd; font: 13px monospace; }
  #frame { display: block; margin: 12px auto; image-rendering: pixelated; }
  #hud { text-align: center; }
</style></head><body>
<img id="frame" width="512" height="512">
<div id="hud">WASD move &middot; Space/Shift up/down &middot; drag to look &middot; <span id="fps"></span></div>
<form id="params" style="text-align:center; margin: 8px">
  <label>pathtracing <input id="pathtracing" type="checkbox"></label>
  <label>filter <input id="filter" type="checkbox"></label>
  <label>temporal <input id="temporal" type="checkbox"></label>
  <label>hdr <input id="hdr" type="checkbox"></label>
  <label>antialiasing <select id="antialiasing">
    <option value="">none</option><option value="fxaa">fxaa</option>
    <option value="taa">taa</option></select></label>
  <label>filter mode <select id="filter_mode">
    <option value="fast">fast</option><option value="compat">compat</option>
  </select></label><br>
  <label>quality <input class="slider" id="render_quality" type="range"
    min="0.1" max="2" step="0.1" value="1"></label>
  <label>spp <input class="slider" id="samples_per_ray" type="range"
    min="1" max="32" value="1"></label>
  <label>bounces <input class="slider" id="max_reflections" type="range"
    min="1" max="16" value="5"></label>
  <label>min importancy <input class="slider" id="min_importancy"
    type="range" min="0" max="1" step="0.1" value="0.3"></label>
</form>
<script>
const img = document.getElementById('frame');
const post = (o) => fetch('/input', {method: 'POST', body: JSON.stringify(o)});
async function loop() {
  while (true) {
    const r = await fetch('/frame.png?' + Date.now());
    const b = await r.blob();
    const url = URL.createObjectURL(b);
    await new Promise((res) => { img.onload = res; img.src = url; });
    URL.revokeObjectURL(url);
    try {
      const s = await (await fetch('/stats')).json();
      document.getElementById('fps').textContent = s.fps.toFixed(1) + ' fps';
    } catch (e) {}
  }
}
loop();
// quality-knob form (exampleLoader.html:30-75 / loader.js:65-93): load
// current values, then POST the whole form on any change — the renderer
// recompiles server-side.
const form = document.getElementById('params');
const ids = ['filter', 'temporal', 'hdr', 'antialiasing', 'filter_mode',
             'render_quality', 'samples_per_ray', 'max_reflections',
             'min_importancy'];
fetch('/config').then(r => r.json()).then(c => {
  document.getElementById('pathtracing').checked = c.renderer !== 'rasterizer';
  for (const k of ids) {
    const el = document.getElementById(k);
    if (el.type === 'checkbox') el.checked = !!c[k];
    else el.value = c[k] === null ? '' : c[k];
  }
});
form.addEventListener('change', () => {
  const msg = {renderer: document.getElementById('pathtracing').checked
               ? 'pathtracer' : 'rasterizer'};
  for (const k of ids) {
    const el = document.getElementById(k);
    msg[k] = el.type === 'checkbox' ? el.checked
           : el.type === 'range' ? Number(el.value)
           : (el.value || null);
  }
  fetch('/config', {method: 'POST', body: JSON.stringify(msg)});
});
window.addEventListener('keydown', (e) => { if (e.target.tagName === 'INPUT' || e.target.tagName === 'SELECT') return; if (!e.repeat) post({type: 'keydown', code: e.code}); });
window.addEventListener('keyup', (e) => post({type: 'keyup', code: e.code}));
let dragging = false, lx = 0, ly = 0;
img.addEventListener('mousedown', (e) => { dragging = true; lx = e.clientX; ly = e.clientY; });
window.addEventListener('mouseup', () => { dragging = false; });
window.addEventListener('mousemove', (e) => {
  if (!dragging) return;
  post({type: 'mouse', dx: e.clientX - lx, dy: e.clientY - ly});
  lx = e.clientX; ly = e.clientY;
});
</script></body></html>"""


class FrameServer:
    """Serve an engine's frames + IO over HTTP (one render thread)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        self.host = host
        self.port = port
        self._latest = None          # (seq, png bytes)
        self._seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._httpd = None
        self._threads = []
        self._png_pool = None        # the PNG encode's row parts, start() to stop()
        # /config mutations queue here; the render thread (the only
        # device user) applies them between frames
        self._pending_config = {}
        self._persist_settings = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> str:
        engine = self.engine
        io = engine.io  # instantiate the WebIo fly camera
        handler = self._make_handler(io)
        self._httpd = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._stop.clear()
        self._png_pool = ThreadPoolExecutor(MAX_PNG_PARTS, thread_name_prefix="flexlight-png")
        self._threads = [
            threading.Thread(target=self._render_loop, name="flexlight-render", daemon=True),
            threading.Thread(target=self._httpd.serve_forever, name="flexlight-http",
                             daemon=True),
        ]
        for t in self._threads:
            t.start()
        return f"http://{self.host}:{self.port}/"

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=10.0)
        if self._png_pool is not None:
            self._png_pool.shutdown()

    def wait_for_frame(self, seq: int = 1, timeout: float = 300.0) -> bool:
        """Block until at least `seq` frames have been served (tests)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._seq >= seq:
                    return True
            time.sleep(0.05)
        return False

    # -- live config (the reference's parameterForm, loader.js:65-93) -------
    _CONFIG_KNOBS = ("filter", "temporal", "hdr", "render_quality",
                     "samples_per_ray", "max_reflections", "min_importancy",
                     "antialiasing", "filter_mode", "first_passes",
                     "second_passes", "temporal_samples")

    def config_snapshot(self) -> dict:
        cfg = self.engine.config
        snap = {k: getattr(cfg, k) for k in self._CONFIG_KNOBS}
        snap["renderer"] = self.engine.renderer.type
        snap["api"] = self.engine.api
        return snap

    def queue_config(self, msg: dict) -> dict:
        """Validate + queue a /config mutation; returns the accepted dict."""
        accepted = {}
        cfg = self.engine.config
        for k in self._CONFIG_KNOBS:
            if k not in msg:
                continue
            cur = getattr(cfg, k)
            v = msg[k]
            if k == "antialiasing":
                v = v if v in ("fxaa", "taa") else None
            elif k == "filter_mode":
                v = v if v in ("fast", "compat") else "fast"
            elif isinstance(cur, bool):
                v = bool(v)
            elif isinstance(cur, int):
                v = max(int(v), 0 if k in ("first_passes", "second_passes")
                        else 1)
            elif isinstance(cur, float):
                v = float(v)
            accepted[k] = v
        for k in ("renderer", "api"):
            if k in msg and isinstance(msg[k], str):
                accepted[k] = msg[k]
        with self._lock:
            self._pending_config.update(accepted)
        return accepted

    def _apply_pending(self):
        with self._lock:
            pending, self._pending_config = self._pending_config, {}
        if not pending:
            return
        engine = self.engine
        renderer = pending.pop("renderer", None)
        api = pending.pop("api", None)
        if pending:
            engine.config = engine.config.replace(**pending)
        if api is not None and api != engine.api:
            engine.api = api
        if renderer is not None and renderer != engine.renderer.type:
            engine.renderer = renderer
        engine.renderer.render()  # re-prepare under the new knobs
        if self._persist_settings:
            from .utils.settings import save_settings

            save_settings(engine.config, renderer=engine.renderer.type)

    # -- render thread (sole device user) -----------------------------------
    def _render_loop(self):
        io = self.engine.io
        self.engine.renderer.render()
        while not self._stop.is_set():
            self._apply_pending()  # /config mutations land between frames
            renderer = self.engine.renderer  # may have been hot-swapped
            # the u8 frame is quantized on the device (4x less fetch
            # traffic than f32). pipelined = swapchain fetch: the
            # device->host copy of frame N-k overlaps the work of the
            # frames after it (models.pathtracer.PathTracer.pipelined).
            if hasattr(renderer, "pipelined"):
                renderer.pipelined = 4
            io.update()  # integrate held keys into the camera (io.js:51-59)
            frame = renderer.render_frame_u8()
            seq = self._seq + 1          # only this thread writes _seq
            parts = png_parts(frame.shape[0])
            with span("fl.serve.encode", seq=seq, parts=parts):
                # fast encode: live view
                data = png_bytes_parts(frame, parts, self._png_pool, level=1)
            with self._lock:
                self._seq = seq
                self._latest = (seq, data)

    # -- http ----------------------------------------------------------------
    def _make_handler(server_self, io):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code, ctype, body: bytes, headers=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for key, value in headers:
                    self.send_header(key, value)
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _VIEWER_HTML.encode())
                elif path == "/frame.png":
                    with server_self._lock:
                        latest = server_self._latest
                    if latest is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        seq, data = latest
                        with span("fl.serve.send", seq=seq):
                            self._send(200, "image/png", data,
                                       headers=(("X-Frame-Seq", str(seq)),))
                elif path == "/config":
                    body = json.dumps(server_self.config_snapshot()).encode()
                    self._send(200, "application/json", body)
                elif path == "/stats":
                    renderer = server_self.engine.renderer
                    rec = renderer.metrics.last or {}
                    with server_self._lock:
                        frames = server_self._seq
                    body = json.dumps({"fps": renderer.fps,
                                       "frames": frames,
                                       "last": rec}).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                path = self.path.split("?")[0]
                if path not in ("/input", "/config"):
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                except ValueError:
                    self._send(400, "text/plain", b"bad json")
                    return
                if path == "/config":
                    accepted = server_self.queue_config(msg)
                    self._send(200, "application/json",
                               json.dumps({"accepted": accepted}).encode())
                    return
                kind = msg.get("type")
                if kind == "keydown":
                    io.key_down(str(msg.get("code", "")))
                elif kind == "keyup":
                    io.key_up(str(msg.get("code", "")))
                elif kind == "mouse":
                    w, h = server_self.engine.canvas
                    io.mouse_move(float(msg.get("dx", 0.0)),
                                  float(msg.get("dy", 0.0)), w, h)
                else:
                    self._send(400, "text/plain", b"unknown input type")
                    return
                self._send(200, "application/json", b"{}")

        return Handler


def main(argv):
    import argparse

    from . import scenes

    ap = argparse.ArgumentParser(prog="python -m flexlight_tpu_torch.serve",
                                 description="Serve a scene's frames over HTTP.")
    ap.add_argument("scene", nargs="?", default="cornell",
                    help="cornell, theater or wave (flexlight_tpu_torch.scenes)")
    ap.add_argument("port", nargs="?", type=int, default=8764)
    ap.add_argument("size", nargs="?", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="the torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.scene == "cornell":
        engine = scenes.cornell(device=args.device)
    elif args.scene == "theater":
        engine = scenes.theater(scenes.stand_in_wood_texture(0), device=args.device)
    elif args.scene == "wave":
        engine = scenes.wave(device=args.device)[0]
    else:
        ap.error(f"unknown scene {args.scene!r}")
    engine.canvas = (args.size, args.size)
    server = FrameServer(engine, port=args.port)
    url = server.start()
    print(f"serving {args.scene} at {url}", flush=True)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
