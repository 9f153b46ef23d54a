"""A minimal Mitsuba 3 XML loader for the cross-validation subset.

Counterpart of ``gvr_tpu/io/mitsuba.py``.  The reference checks its sphere
renders against Mitsuba's ``volpath`` on
``tests/env_one_sphere_test_ortho.xml`` (SURVEY §4.3); this loader reads
that family of scenes: an orthographic or perspective sensor by lookat
(film width and height, ``fov``), constant and point emitters,
homogeneous media by id (``sigma_t`` times ``scale``, ``albedo``) and
sphere shapes that ``ref`` their medium.  It returns (scene, camera,
width, height) for ``render_raymarch_spheres``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from gvr_tpu_torch.cameras import OrthographicCamera, PinholeCamera
from gvr_tpu_torch.scene.scene import DEFAULT_ENV_COLOR, make_scene
from gvr_tpu_torch.scene.spheres import SphereMixture


def _rgb(val: str):
    parts = [float(v) for v in val.replace(",", " ").split()]
    if len(parts) == 1:
        parts = parts * 3
    return np.asarray(parts[:3], np.float32)


def _point(el):
    return [float(el.get(k, 0)) for k in ("x", "y", "z")]


def load_mitsuba(path: str, device="cpu"):
    """Parse the supported Mitsuba XML subset: (scene, camera, width,
    height), the scene and camera on ``device``."""
    root = ET.parse(path).getroot()

    sensor = root.find("sensor")
    lookat = sensor.find("./transform/lookat")
    origin = _rgb(lookat.get("origin"))
    target = _rgb(lookat.get("target"))
    w = h = 512
    for integer in sensor.find("film").findall("integer"):
        if integer.get("name") == "width":
            w = int(integer.get("value"))
        if integer.get("name") == "height":
            h = int(integer.get("value"))
    fov = 45.0
    for f in sensor.findall("float"):
        if f.get("name") == "fov":
            fov = float(f.get("value"))
    if sensor.get("type", "orthographic") == "orthographic":
        camera = OrthographicCamera.create(origin, target, device=device)
    else:
        camera = PinholeCamera.create(origin, target, float(np.deg2rad(fov)),
                                      device=device)

    env_color = np.asarray(DEFAULT_ENV_COLOR, np.float32)
    lights = []
    for em in root.findall("emitter"):
        if em.get("type") == "constant":
            env_color = _rgb(em.find("rgb").get("value"))
        elif em.get("type") == "point":
            lights.append(np.concatenate([
                np.asarray(_point(em.find("point")), np.float32),
                _rgb(em.find("rgb").get("value"))]))

    # media by id: sigma_t * scale and albedo -> (sigma_a, sigma_s), with
    # the JAX package's float32 defaults (so numpy rounds alike)
    media = {}
    for med in root.findall("medium"):
        albedo, sigma_t, scale = np.float32(1.0), np.float32(1.0), 1.0
        for rgb in med.findall("rgb"):
            if rgb.get("name") == "albedo":
                albedo = float(_rgb(rgb.get("value"))[0])
            if rgb.get("name") == "sigma_t":
                sigma_t = float(_rgb(rgb.get("value"))[0])
        for fl in med.findall("float"):
            if fl.get("name") == "scale":
                scale = float(fl.get("value"))
        st = sigma_t * scale
        media[med.get("id")] = (st * (1.0 - albedo), st * albedo)

    centers, radii, sa, ss = [], [], [], []
    for shape in root.findall("shape"):
        if shape.get("type") != "sphere":
            continue
        pt = shape.find("point")
        radius = 1.0
        for fl in shape.findall("float"):
            if fl.get("name") == "radius":
                radius = float(fl.get("value"))
        ref = shape.find("ref")
        if ref is None:
            med = (0.0, 1.0)
        else:
            med = media.get(ref.get("id"))
            if med is None:
                raise ValueError(
                    f"sphere references undefined medium id "
                    f"{ref.get('id')!r} (declared media: {sorted(media)})")
        centers.append(_point(pt) if pt is not None else [0, 0, 0])
        radii.append(radius)
        sa.append(med[0])
        ss.append(med[1])

    smm = SphereMixture.create(np.asarray(centers, np.float32),
                               np.asarray(radii, np.float32),
                               np.asarray(sa, np.float32),
                               np.asarray(ss, np.float32), device=device)
    return make_scene(smm, lights, env_color, device), camera, w, h
