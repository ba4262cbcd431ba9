"""PyTorch port: the interactive viewer (viewer.py) against the JAX
package's (CPU).

  * `png_encode` gives the JAX encoder's bytes on random u8 frames;
  * tests/test_viewer.py's end-to-end case on the CPU: page, status, the
    'z' toggle, the 's' save, a bounded render loop through
    render.render_with_stats, the published PNG (its pixels `to_u8` of the
    published mean, rows flipped to display order) and the click probe.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import json
import os
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from scheme_raytrace_tpu.viewer import png_encode as j_png_encode
from scheme_raytrace_torch import render as t_render
from scheme_raytrace_torch import scenes
from scheme_raytrace_torch.config import RenderConfig
from scheme_raytrace_torch.scene import compile_scene
from scheme_raytrace_torch.viewer import Viewer, png_encode


def png_pixels(data):
    """RGB8 pixels of an unfiltered PNG (the encoders' own layout)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                              "big")
    at, idat = 8, b""
    while at < len(data):
        n = int.from_bytes(data[at:at + 4], "big")
        if data[at + 4:at + 8] == b"IDAT":
            idat += data[at + 8:at + 8 + n]
        at += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(7, 5, 3), (1, 1, 3), (16, 33, 3)])
def test_png_encode_equals_jax(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    data = png_encode(img)
    assert data == j_png_encode(img)
    np.testing.assert_array_equal(png_pixels(data), img)


def test_viewer_end_to_end(tmp_path):
    spec = scenes.cornell_box()
    scene = compile_scene(spec.objects, sky=spec.sky, device="cpu")
    cam = spec.camera(aspect=1.0, device="cpu")
    cfg = RenderConfig(nx=16, ny=16, spp=1, max_depth=4,
                       light_sampling=True, pool_rays=256)
    out = str(tmp_path / "view.ppm")
    v = Viewer(scene, cam, cfg, scene_name="cornell", spp_target=2,
               out=out, port=0, chunk=1)
    v.start_server()
    base = f"http://127.0.0.1:{v.port}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.read()

    def post(path):
        req = urllib.request.Request(base + path, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.read()

    try:
        assert b"scheme_raytrace_torch" in get("/")
        assert json.loads(get("/status"))["samples"] == 0

        assert json.loads(post("/toggle"))["paused"] is True
        assert json.loads(post("/toggle"))["paused"] is False

        post("/save")
        state = v.render_loop()
        assert int(state.sample_count) == 2
        assert os.path.exists(out)

        st = json.loads(get("/status"))
        assert st["samples"] == 2 and st["scene"] == "cornell"
        assert st["rays_per_s"] > 0

        mean = state.raw_sum.numpy() / 2
        np.testing.assert_array_equal(png_pixels(get("/frame.png")),
                                      t_render.to_u8(mean)[::-1])

        p = json.loads(get("/probe?x=8&y=8"))
        assert p["samples"] == 2 and len(p["mean_radiance"]) == 3
        np.testing.assert_allclose(p["mean_radiance"], mean[8, 8],
                                   rtol=1e-6)
        assert p["display_u8"] == t_render.to_u8(mean)[8, 8].tolist()
        assert max(p["mean_radiance"]) > 0.0
        with pytest.raises(urllib.error.HTTPError) as bad:
            get("/probe?x=a")
        assert bad.value.code == 400
    finally:
        v.stop()
