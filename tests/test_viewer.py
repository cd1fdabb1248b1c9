"""Viewer server: frame streaming + event plumbing (no browser needed)."""
import json
import urllib.request

import numpy as np
import pytest

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera, Trackball
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.renderer import Renderer
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.probe import build_probe
from optixpathtracer.viewer.server import ViewerServer


def _renderer():
    hs = HostScene()
    hs.add_box(make_material(color=(0.8, 0.8, 0.8)), pos=(0, -0.1, 0), extent=(6, 0.1, 6))
    cs = compile_scene(hs)
    probe = build_probe(np.full((8, 16, 3), 0.5, np.float32))
    cfg = RenderConfig(width=32, height=24, samples_per_launch=1, max_depth=1)
    cam = Camera(eye=(3, 2, 4), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=45, aspect_ratio=4 / 3)
    return Renderer(cs, probe, cfg, cam), cam


@pytest.mark.slow
def test_viewer_serves_frames_and_events():
    r, cam = _renderer()
    tb = Trackball(cam)
    server = ViewerServer(r, port=0, trackball=tb)
    server.start()
    try:
        frame = r.render()
        server.publish(frame)
        base = f"http://127.0.0.1:{server.port}"

        page = urllib.request.urlopen(base + "/", timeout=5).read()
        assert b"optixpathtracer" in page

        png = urllib.request.urlopen(base + "/frame.png", timeout=5).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"  # PNG signature

        stats = json.loads(urllib.request.urlopen(base + "/stats", timeout=5).read())
        assert stats["frames"] == 1

        eye_before = cam.eye.copy()
        urllib.request.urlopen(base + "/event?type=wheel&d=1", timeout=5)
        assert server.camera_changed
        assert not np.allclose(cam.eye, eye_before)  # zoom moved the eye

        urllib.request.urlopen(base + "/event?type=down&x=5&y=5&b=0", timeout=5)
        urllib.request.urlopen(base + "/event?type=move&x=15&y=9&b=0", timeout=5)
        # orbit moved the camera again
    finally:
        server.stop()


def test_trackball_orbit_preserves_distance():
    cam = Camera(eye=(3, 0, 0), lookat=(0, 0, 0), up=(0, 1, 0), fov_y=45)
    tb = Trackball(cam)
    d0 = np.linalg.norm(cam.eye - cam.lookat)
    tb.start_tracking(0, 0)
    tb.update_tracking(40, 25, 200, 200)
    d1 = np.linalg.norm(cam.eye - cam.lookat)
    np.testing.assert_allclose(d0, d1, rtol=1e-4)
    assert not np.allclose(cam.eye, (3, 0, 0))
