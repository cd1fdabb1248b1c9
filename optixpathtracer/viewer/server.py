"""Interactive web viewer — the display stack for a renderer that lives on a
headless accelerator host.

Replaces the reference's GL display chain (sutil/GLDisplay fullscreen-quad
blit of the CUDA-interop PBO + GLFW window + imgui stats overlay,
sutil/sutil.cpp initUI/displayStats :723-852): the render host has no
display, so frames stream to a browser over HTTP (a multipart PNG stream)
and mouse events come back —
drag orbits the trackball (main.cpp cursorPosCallback:30-46 semantics), wheel
zooms, and cursor position drives the foveation gaze (sv4 main.cpp:310-314).

Zero dependencies: stdlib http.server + the numpy PNG encoder.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>optixpathtracer</title><style>
body{margin:0;background:#111;color:#ddd;font:13px monospace}
#wrap{display:flex;gap:12px;padding:10px}
img{image-rendering:pixelated;cursor:crosshair;border:1px solid #333}
#stats{white-space:pre}
</style></head><body><div id="wrap">
<img id="view" src="/stream">
<div id="stats">connecting...</div></div>
<script>
const img = document.getElementById('view');
let drag = false, btn = 0;
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('mousedown', e => {drag = true; btn = e.button;
  fetch(`/event?type=down&x=${e.offsetX}&y=${e.offsetY}&b=${btn}`);});
window.addEventListener('mouseup', () => {drag = false;});
img.addEventListener('mousemove', e => {
  fetch(`/event?type=move&x=${e.offsetX}&y=${e.offsetY}&b=${drag ? btn : -1}`);});
img.addEventListener('wheel', e => {e.preventDefault();
  fetch(`/event?type=wheel&d=${e.deltaY > 0 ? -1 : 1}`);});
setInterval(async () => {
  const r = await fetch('/stats');
  document.getElementById('stats').textContent = JSON.stringify(await r.json(), null, 2);
}, 500);
</script></body></html>"""


class ViewerServer:
    """Streams a renderer's frames; feeds pointer events to camera/gaze."""

    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 8000,
                 trackball=None):
        self.renderer = renderer
        self.trackball = trackball
        self._frame_lock = threading.Lock()
        self._frame_bytes: bytes | None = None
        self._running = False
        self.host, self.port = host, port
        self._httpd: ThreadingHTTPServer | None = None
        self.camera_changed = False

    # -- frame publication (called from the render loop) -------------------
    def publish(self, frame: np.ndarray) -> None:
        from ..io.image import encode_png

        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        data = encode_png(arr[..., :3])
        with self._frame_lock:
            self._frame_bytes = data

    # -- event plumbing -----------------------------------------------------
    def _on_event(self, q: dict) -> None:
        typ = q.get("type", [""])[0]
        if typ == "wheel" and self.trackball is not None:
            self.trackball.zoom(int(q.get("d", ["1"])[0]))
            self.camera_changed = True
        elif typ in ("down", "move"):
            x = int(q.get("x", ["0"])[0])
            y = int(q.get("y", ["0"])[0])
            b = int(q.get("b", ["-1"])[0])
            if hasattr(self.renderer, "set_gaze"):
                self.renderer.set_gaze(x, y)  # gaze follows cursor (sv4)
            if self.trackball is not None:
                if typ == "down":
                    self.trackball.start_tracking(x, y)
                elif b == 0:
                    self.trackball.update_tracking(
                        x, y, self.renderer.config.width, self.renderer.config.height
                    )
                    self.camera_changed = True

    def _stats(self) -> dict:
        try:
            return self.renderer.stats()
        except Exception:
            return {}

    # -- server -------------------------------------------------------------
    def start(self) -> None:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                u = urlparse(self.path)
                if u.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/stats":
                    body = json.dumps(viewer._stats()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/event":
                    viewer._on_event(parse_qs(u.query))
                    self.send_response(204)
                    self.end_headers()
                elif u.path == "/frame.png":
                    with viewer._frame_lock:
                        data = viewer._frame_bytes
                    if data is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "multipart/x-mixed-replace; boundary=frame"
                    )
                    self.end_headers()
                    try:
                        last = None
                        while viewer._running:
                            with viewer._frame_lock:
                                data = viewer._frame_bytes
                            if data is not None and data is not last:
                                self.wfile.write(b"--frame\r\n")
                                self.wfile.write(b"Content-Type: image/png\r\n")
                                self.wfile.write(
                                    f"Content-Length: {len(data)}\r\n\r\n".encode()
                                )
                                self.wfile.write(data)
                                self.wfile.write(b"\r\n")
                                last = data
                            time.sleep(0.03)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

        self._running = True
        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._running = False
        if self._httpd:
            self._httpd.shutdown()
            self._httpd = None


def run_interactive(renderer, camera, host="127.0.0.1", port=8000, max_frames=None):
    """Render loop: render -> publish -> handle camera changes (main.cpp:253-289)."""
    from ..core.camera import Trackball

    tb = Trackball(camera)
    tb.set_reference_frame((1, 0, 0), (0, 0, 1), (0, 1, 0))
    tb.gimbal_lock = True
    server = ViewerServer(renderer, host, port, trackball=tb)
    server.start()
    print(f"viewer at http://{server.host}:{server.port}/")
    frames = 0
    try:
        while max_frames is None or frames < max_frames:
            if server.camera_changed:
                renderer.set_camera(camera)  # resets accumulation
                server.camera_changed = False
            frame = renderer.render()
            server.publish(frame)
            frames += 1
    finally:
        server.stop()
    return server
