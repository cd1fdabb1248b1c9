"""Shared scene/render setups for the golden-image regression suite.

Used both by tests/test_goldens.py (compare against committed goldens) and
by tests/regen_goldens.py (regenerate them after an INTENTIONAL radiometric
change). Everything is deterministic: fixed seeds, fixed subframe counts,
CPU lockstep traversal (exact), low resolutions.
"""
from __future__ import annotations

import numpy as np

from optixpathtracer.builder import compile_scene
from optixpathtracer.core.camera import Camera
from optixpathtracer.core.materials import make_material
from optixpathtracer.core.scene import HostScene
from optixpathtracer.engine.wavefront import RenderConfig
from optixpathtracer.lights.lights import QuadLight
from optixpathtracer.lights.probe import build_probe

W, H = 96, 64


def _sky_probe():
    sky = np.full((32, 64, 3), 0.35, np.float32)
    sky[4:7, 12:16] = (40.0, 36.0, 30.0)  # sun block
    sky[20:, :] = 0.08  # dark ground hemisphere
    return build_probe(sky)


def _open_scene():
    hs = HostScene()
    hs.add_box(make_material(color=(0.75, 0.75, 0.75)), pos=(0, -0.1, 0), extent=(8, 0.1, 8))
    hs.add_box(make_material(color=(0.7, 0.25, 0.2), roughness=0.4), pos=(-0.9, 0.5, 0), extent=(0.5, 0.5, 0.5))
    hs.add_box(make_material(color=(0.9, 0.8, 0.25), metallic=1.0, roughness=0.15), pos=(0.9, 0.4, 0.3), extent=(0.4, 0.4, 0.4))
    hs.add_box(make_material(color=(0.9, 0.9, 0.9), transmission=1.0, eta=1.5), pos=(0.0, 0.45, 1.3), extent=(0.35, 0.45, 0.35))
    return hs


def _cornell_scene():
    hs = HostScene()
    e = 1.5
    hs.add_box(make_material(color=(0.73, 0.73, 0.73)), pos=(0, -0.05, 0), extent=(e, 0.05, e))  # floor
    hs.add_box(make_material(color=(0.73, 0.73, 0.73)), pos=(0, 2 * e + 0.05, 0), extent=(e, 0.05, e))  # ceiling
    hs.add_box(make_material(color=(0.65, 0.05, 0.05)), pos=(-e - 0.05, e, 0), extent=(0.05, e, e))  # red left
    hs.add_box(make_material(color=(0.12, 0.45, 0.15)), pos=(e + 0.05, e, 0), extent=(0.05, e, e))  # green right
    hs.add_box(make_material(color=(0.73, 0.73, 0.73)), pos=(0, e, -e - 0.05), extent=(e, e, 0.05))  # back
    hs.add_box(make_material(color=(0.73, 0.73, 0.73), roughness=0.5), pos=(-0.5, 0.6, -0.4), extent=(0.35, 0.6, 0.35))
    hs.add_box(make_material(color=(0.73, 0.73, 0.73), metallic=1.0, roughness=0.1), pos=(0.55, 0.35, 0.35), extent=(0.35, 0.35, 0.35))
    # emissive quad light geometry near the ceiling
    hs.add_box(make_material(color=(0, 0, 0), emission=(15.0, 13.0, 10.0)), pos=(0, 2 * e - 0.02, 0), extent=(0.5, 0.02, 0.5))
    return hs


def _cam(eye, lookat):
    return Camera(eye=eye, lookat=lookat, up=(0, 1, 0), fov_y=45, aspect_ratio=W / H)


def render_disney_open(frames=2):
    from optixpathtracer.engine.renderer import Renderer

    cs = compile_scene(_open_scene())
    cfg = RenderConfig(width=W, height=H, samples_per_launch=4, max_depth=3,
                       traversal="lockstep")
    r = Renderer(cs, _sky_probe(), cfg, _cam((3.2, 2.2, 4.0), (0, 0.4, 0)))
    r.render_n(frames)
    return r.accum_image()


def render_disney_cornell(frames=2):
    from optixpathtracer.engine.renderer import Renderer

    cs = compile_scene(_cornell_scene())
    probe = build_probe(np.full((8, 16, 3), 0.0, np.float32) + 1e-6)
    light = QuadLight.make(
        corner=(-0.5, 2.96, -0.5), v1=(1.0, 0, 0), v2=(0, 0, 1.0),
        emission=(15.0, 13.0, 10.0),
    )
    cfg = RenderConfig(width=W, height=H, samples_per_launch=4, max_depth=3,
                       traversal="lockstep", emission_all_bounces=True)
    r = Renderer(cs, probe, cfg, _cam((0, 1.5, 5.6), (0, 1.4, 0)),
                 area_light=light)
    r.render_n(frames)
    return r.accum_image()


def render_hello():
    from optixpathtracer.models import make_hello_renderer

    cs = compile_scene(_open_scene())
    return make_hello_renderer(cs, _cam((3.2, 2.2, 4.0), (0, 0.4, 0)), W, H).render()


def render_whitted():
    from optixpathtracer.models.whitted import make_renderer

    r = make_renderer(width=W, height=H, max_depth=3)
    return r.render()


def render_spectral(frames=2):
    from optixpathtracer.engine.spectral import SpectralRenderer

    cs = compile_scene(_open_scene())
    cfg = RenderConfig(width=W, height=H, samples_per_launch=2, max_depth=3,
                       traversal="lockstep")
    r = SpectralRenderer(cs, _sky_probe(), cfg, _cam((3.2, 2.2, 4.0), (0, 0.4, 0)))
    img = None
    for _ in range(frames):
        img = r.render()
    return img


def render_foveated(frames=2):
    from optixpathtracer.engine.foveated import FoveatedRenderer, FoveationConfig

    cs = compile_scene(_open_scene())
    cfg = RenderConfig(width=W, height=H, samples_per_launch=1, max_depth=2,
                       traversal="lockstep")
    fov = FoveationConfig()
    r = FoveatedRenderer(cs, _sky_probe(), cfg, _cam((3.2, 2.2, 4.0), (0, 0.4, 0)), fov)
    for _ in range(frames):
        r.render()
    return r.accum_image()


def render_gltf():
    """glTF ingest golden: procedural two-node glb built in-memory."""
    import json as _json
    import struct
    import tempfile

    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.io.gltf import load_gltf

    # one triangle-quad mesh instanced by two nodes with different transforms
    pos = np.array(
        [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32
    )
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    bin_pos = pos.tobytes()
    bin_idx = idx.tobytes() + b"\x00\x00"  # pad to 4
    blob = bin_pos + bin_idx
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0},
            {"mesh": 0, "translation": [0.0, 1.0, 0.0],
             "scale": [0.5, 0.5, 0.5]},
        ],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 1}, "indices": 0, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.3, 0.2, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.6}}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": len(bin_pos), "byteLength": 12},
            {"buffer": 0, "byteOffset": 0, "byteLength": len(bin_pos)},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5123, "count": 6, "type": "SCALAR"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3",
             "min": pos.min(0).tolist(), "max": pos.max(0).tolist()},
        ],
    }
    js = _json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    glb = (
        struct.pack("<4sII", b"glTF", 2, 12 + 8 + len(js) + 8 + len(blob))
        + struct.pack("<I4s", len(js), b"JSON") + js
        + struct.pack("<I4s", len(blob), b"BIN\x00") + blob
    )
    with tempfile.NamedTemporaryFile(suffix=".glb", delete=False) as f:
        f.write(glb)
        path = f.name
    hs, _lights = load_gltf(path)
    cs = compile_scene(hs)
    cfg = RenderConfig(width=W, height=H, samples_per_launch=2, max_depth=2,
                       traversal="lockstep")
    r = Renderer(cs, _sky_probe(), cfg, _cam((3.0, 2.5, 3.0), (0, 0.4, 0)))
    r.render_n(2)
    return r.accum_image()


def render_loft(frames=2):
    """Textured closed interior (scenes/loft.obj): exercises texture
    sampling, shading normals and emissive-geometry lighting at once."""
    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.io.obj import load_obj

    cs = compile_scene(load_obj("scenes/loft.obj"))
    probe = build_probe(np.full((8, 16, 3), 0.0, np.float32) + 1e-6)
    cfg = RenderConfig(width=W, height=H, samples_per_launch=4, max_depth=3,
                       traversal="lockstep", emission_all_bounces=True,
                       use_shading_normals=True)
    r = Renderer(cs, probe, cfg, _cam((-5.2, 2.4, 3.2), (2.0, 1.2, -1.0)))
    r.render_n(frames)
    return r.accum_image()


# ---- fast-tier small variants (VERDICT r3 item 6) -------------------------
# every preset keeps a tiny golden in the DEFAULT test tier so whitted /
# disney / spectral / foveated / loft radiometry can't regress invisibly
# between slow-tier runs. Same scenes and code paths, shrunk launch geometry.
WS, HS = 48, 32


def _cam_s(eye, lookat):
    return Camera(eye=eye, lookat=lookat, up=(0, 1, 0), fov_y=45,
                  aspect_ratio=WS / HS)


def render_disney_open_small():
    from optixpathtracer.engine.renderer import Renderer

    cs = compile_scene(_open_scene())
    cfg = RenderConfig(width=WS, height=HS, samples_per_launch=2, max_depth=2,
                       traversal="lockstep")
    r = Renderer(cs, _sky_probe(), cfg, _cam_s((3.2, 2.2, 4.0), (0, 0.4, 0)))
    r.render()
    return r.accum_image()


def render_disney_cornell_small():
    from optixpathtracer.engine.renderer import Renderer

    cs = compile_scene(_cornell_scene())
    probe = build_probe(np.full((8, 16, 3), 0.0, np.float32) + 1e-6)
    light = QuadLight.make(
        corner=(-0.5, 2.96, -0.5), v1=(1.0, 0, 0), v2=(0, 0, 1.0),
        emission=(15.0, 13.0, 10.0),
    )
    cfg = RenderConfig(width=WS, height=HS, samples_per_launch=2, max_depth=2,
                       traversal="lockstep", emission_all_bounces=True)
    r = Renderer(cs, probe, cfg, _cam_s((0, 1.5, 5.6), (0, 1.4, 0)),
                 area_light=light)
    r.render()
    return r.accum_image()


def render_whitted_small():
    from optixpathtracer.models.whitted import make_renderer

    r = make_renderer(width=WS, height=HS, max_depth=2)
    return r.render()


def render_spectral_small():
    from optixpathtracer.engine.spectral import SpectralRenderer

    cs = compile_scene(_open_scene())
    cfg = RenderConfig(width=WS, height=HS, samples_per_launch=1, max_depth=2,
                       traversal="lockstep")
    r = SpectralRenderer(cs, _sky_probe(), cfg, _cam_s((3.2, 2.2, 4.0), (0, 0.4, 0)))
    return r.render()


def render_foveated_small():
    from optixpathtracer.engine.foveated import FoveatedRenderer, FoveationConfig

    cs = compile_scene(_open_scene())
    cfg = RenderConfig(width=WS, height=HS, samples_per_launch=1, max_depth=1,
                       traversal="lockstep")
    fov = FoveationConfig(inner_radius=8, outer_radius=16)
    r = FoveatedRenderer(cs, _sky_probe(), cfg,
                         _cam_s((3.2, 2.2, 4.0), (0, 0.4, 0)), fov)
    r.render()
    return r.accum_image()


def render_loft_small():
    from optixpathtracer.engine.renderer import Renderer
    from optixpathtracer.io.obj import load_obj

    cs = compile_scene(load_obj("scenes/loft.obj"))
    probe = build_probe(np.full((8, 16, 3), 0.0, np.float32) + 1e-6)
    cfg = RenderConfig(width=WS, height=HS, samples_per_launch=2, max_depth=2,
                       traversal="lockstep", emission_all_bounces=True,
                       use_shading_normals=True)
    r = Renderer(cs, probe, cfg, _cam_s((-5.2, 2.4, 3.2), (2.0, 1.2, -1.0)))
    r.render()
    return r.accum_image()


GOLDENS = {
    "disney_open": render_disney_open,
    "disney_cornell": render_disney_cornell,
    "hello": render_hello,
    "whitted": render_whitted,
    "spectral": render_spectral,
    "foveated": render_foveated,
    "gltf": render_gltf,
    "loft": render_loft,
    # fast-tier small variants
    "disney_open_s": render_disney_open_small,
    "disney_cornell_s": render_disney_cornell_small,
    "whitted_s": render_whitted_small,
    "spectral_s": render_spectral_small,
    "foveated_s": render_foveated_small,
    "loft_s": render_loft_small,
}
