"""Command-line renderer — counterpart of the `mitsuba` CLI
(src/mitsuba/mitsuba.cpp): parse a scene (JSON, or Mitsuba-0.5 XML
subset), run the requested integrator, write the image.

Usage:
  python scripts/render_cli.py scene.json -o out.pfm \
      [-i vrl|alvrl|volpath] [-p passes] [-D key=value] [--seed N]
      [--particles N] [--vrls N] [--png preview.png] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import scripts._cache  # noqa: F401


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("-o", "--output", default="out.pfm")
    ap.add_argument("-i", "--integrator", default="vrl",
                    choices=["vrl", "alvrl", "volpath", "path", "direct",
                             "bdpt", "ptracer", "photonmap", "pssmlt",
                             "mlt", "erpt", "vpl", "adaptive", "irrcache",
                             "field", "motion"])
    ap.add_argument("--field", default="distance",
                    help="AOV for -i field (misc/field.cpp kinds)")
    ap.add_argument("--depth", type=int, default=16,
                    help="max path depth for path-tracing integrators")
    ap.add_argument("-p", "--passes", type=int, default=4)
    ap.add_argument("-D", "--define", action="append", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--particles", type=int, default=128)
    ap.add_argument("--vrls", type=int, default=512)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--png", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-L", "--log-level", default="INFO")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from alvrl_tpu.core.logging import configure, get_logger
    from alvrl_tpu.core.stats import STATS
    from alvrl_tpu.io import image as image_io
    from alvrl_tpu.scene import loader

    configure(args.log_level)
    log = get_logger("cli")

    defines = dict(kv.split("=", 1) for kv in args.define)
    if args.scene.endswith(".xml"):
        desc = loader.convert_mitsuba_xml(args.scene, defines)
        scene = loader.build_scene(desc)
    else:
        scene = loader.load_json(args.scene, defines)
    log.info("scene: %d tris, %dx%d", scene.num_tris,
             scene.camera.width, scene.camera.height)

    t0 = time.time()
    import numpy as np

    key = jax.random.key(args.seed)
    if args.integrator == "volpath":
        from alvrl_tpu.integrators import volpath

        img = np.asarray(volpath.render_volpath(
            scene, key, spp=args.spp,
        ))
    elif args.integrator == "path":
        from alvrl_tpu.integrators import surface

        img = np.asarray(surface.render_path(
            scene, key, spp=args.spp, max_depth=args.depth))
    elif args.integrator == "direct":
        from alvrl_tpu.integrators import surface

        img = np.asarray(surface.render_direct(scene, key, spp=args.spp))
    elif args.integrator == "bdpt":
        from alvrl_tpu.integrators import bdpt

        img = np.asarray(bdpt.render_bdpt(scene, key, spp=args.spp))
    elif args.integrator == "ptracer":
        from alvrl_tpu.integrators import ptracer

        img = np.asarray(ptracer.render_ptracer(
            scene, key, num_particles=max(args.particles, 4096)))
    elif args.integrator == "photonmap":
        from alvrl_tpu.integrators import photonmap

        img = np.asarray(photonmap.render_ppm(
            scene, key, n_passes=args.passes))
    elif args.integrator == "pssmlt":
        from alvrl_tpu.integrators import pssmlt

        img = np.asarray(pssmlt.render_pssmlt(scene, key))
    elif args.integrator == "mlt":
        from alvrl_tpu.integrators import mlt

        img = np.asarray(mlt.render_mlt(scene, key))
    elif args.integrator == "erpt":
        from alvrl_tpu.integrators import erpt

        img = np.asarray(erpt.render_erpt(scene, key))
    elif args.integrator == "vpl":
        from alvrl_tpu.integrators import vpl as vpl_mod

        vpls = vpl_mod.generate_vpls(scene, key, max(args.particles, 64))
        img = np.asarray(vpl_mod.render_vpl(scene, vpls, key))
    elif args.integrator == "adaptive":
        from alvrl_tpu.integrators import adaptive

        img, _spp = adaptive.render_adaptive(scene, key)
        img = np.asarray(img)
    elif args.integrator == "irrcache":
        from alvrl_tpu.integrators import irrcache

        img, _cache = irrcache.render_irrcache(scene, key)
        img = np.asarray(img)
    elif args.integrator == "field":
        from alvrl_tpu.integrators import field as field_mod

        img = np.asarray(field_mod.render_field(scene, args.field))
    elif args.integrator == "motion":
        from alvrl_tpu.integrators import motion

        img = np.asarray(motion.render_motion_vectors(scene))
    else:
        from alvrl_tpu.integrators.progressive import (
            ProgressiveConfig,
            render_progressive,
        )
        from alvrl_tpu.integrators.vrl.alvrl import ALVRLParams

        img = render_progressive(
            scene, jax.random.key(args.seed),
            ProgressiveConfig(
                max_passes=args.passes,
                clustered=(args.integrator == "alvrl"),
            ),
            ALVRLParams(vrl_target_num=args.vrls,
                        num_particles=args.particles),
        )
    log.info("rendered in %.1fs, mean %.4g", time.time() - t0, img.mean())

    if args.output.endswith(".npy"):
        image_io.write_npy(args.output, img)
    elif args.output.endswith((".jpg", ".jpeg")):
        from alvrl_tpu.io import jpeg as jpeg_io

        jpeg_io.write_jpeg(args.output, image_io.tonemap(img))
    elif args.output.endswith(".exr"):
        from alvrl_tpu.io import exr as exr_io

        exr_io.write_exr(args.output, img)
    else:
        image_io.write_pfm(args.output, img)
    if args.png:
        image_io.write_png(args.png, img)
    log.info("wrote %s", args.output)
    print(STATS.format_table(), file=sys.stderr)


if __name__ == "__main__":
    main()
