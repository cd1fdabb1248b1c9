"""Record a live interactive foveated session artifact (VERDICT r4 item 3).

Drives the viewer's render loop headlessly at 640x480 with a scripted
circular gaze path and the composed pipeline (fused 3-zone foveation +
sobol + Russian roulette + denoised fovea display) via
bench.interactive_line, and writes the per-frame TSV in the reference's own
data_save.dat column format (sv3 main.cpp:348-383) to
docs/sessions/interactive_640x480.tsv — the committed analog of the
reference's committed session traces (data.tsv, written by
sutil/sutil.cpp:758-773).

Run (on the GPU):  PYTHONPATH=.:$PYTHONPATH python tools/interactive_session.py [--frames N]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from optixpathtracer.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import bench as B
    from optixpathtracer.builder import compile_scene
    from optixpathtracer.lights.probe import build_probe

    hs = B.build_city_scene(n_boxes=12500)
    cs = compile_scene(hs, leaf_size=8, wide_width=8, build_wide_bvh=False)
    sky = np.full((64, 128, 3), 0.4, np.float32)
    sky[8:12, 30:34] = (60.0, 55.0, 45.0)
    probe = build_probe(sky)
    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", "sessions", "interactive_640x480.tsv")
    rec = B.interactive_line(cs, probe, frames=args.frames, record_path=out)
    print(json.dumps(rec))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
