"""Multichannel meta-integrator.

Counterpart of the `multichannel` plugin (src/integrators/misc/
multichannel.cpp): renders several sub-integrators over the same camera
rays and packs each result into named channels of one multichannel EXR
(the reference pairs it with `field` to dump depth / normals / albedo
alongside the beauty pass).

Array-native design: sub-renders are independent jit-compiled passes over
the same deterministic pixel grid (rather than interleaved per-sample
as in the reference's renderBlock loop — per-pixel values are identical
because each pass integrates the same estimator to convergence
independently); channels are bundled host-side and written with
io.exr.write_exr_channels.
"""

from __future__ import annotations

import numpy as np

from alvrl_tpu.integrators import field as field_mod
from alvrl_tpu.scene.scene import Scene


def render_multichannel(scene: Scene, specs, key=None):
    """Run each spec and return {channel_name: (H, W) f32}.

    specs: list of (name, spec) where spec is either
      * "field:<kind>" — a field-extraction pass (misc/field.cpp), or
      * a callable scene -> (H, W, 3) or (H, W) image (any renderer,
        e.g. partial(render_volpath, key=key, spp=64)).
    Vector results expand to `<name>.R/.G/.B` (the reference's
    multi-channel hdrfilm naming); scalars keep `name`.
    """
    channels = {}
    for name, spec in specs:
        if isinstance(spec, str):
            if not spec.startswith("field:"):
                raise ValueError(f"unknown spec string {spec!r}")
            img = field_mod.render_field(scene, spec[len("field:"):])
        else:
            img = spec(scene)
        img = np.asarray(img)
        if img.ndim == 2:
            channels[name] = img
        elif img.shape[-1] == 1:
            channels[name] = img[..., 0]
        else:
            for i, suffix in enumerate("RGB"[: img.shape[-1]]):
                channels[f"{name}.{suffix}"] = img[..., i]
    return channels


def write_multichannel_exr(path, channels):
    from alvrl_tpu.io import exr

    exr.write_exr_channels(path, channels)
