"""The port's CLI on the CPU: ``--device cpu`` at 24x18, 2 spp writes a
PNG equal, byte for byte, to the port's ``render`` of the same config
quantized as the CLI quantizes (the JAX package's rounding).  The PNG is
read back with the decoder of tests/test_torch_goldens.py.
"""
import numpy as np

from tpu_pathtracer_torch import cli
from tpu_pathtracer_torch.render.integrator import RenderConfig, render
from tpu_pathtracer_torch.scenes import load_scene

from test_torch_goldens import read_png_rgb8
from test_torch_slice_scene0 import two_torch_threads  # noqa: F401


def test_cli_writes_the_render(tmp_path, capsys):
    out = tmp_path / "out.png"
    rc = cli.main(["--scene", "0", "--renderer", "nee", "--device", "cpu",
                   "--width", "24", "--height", "18", "--spp", "2",
                   "--max-depth", "4", "--table-res", "16", "-o", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "Scene build:" in printed and "Render:" in printed
    assert f"Saved {out}" in printed
    png = read_png_rgb8(out)
    scene, meta, cam = load_scene(0, 24, 18, table_res=16, device="cpu")
    cfg = RenderConfig(width=24, height=18, spp=2, max_depth=4,
                       strategy="nee", sampler="sobol", seed=0)
    img = render(scene, meta, cam, cfg, device="cpu").numpy()
    expected = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    assert png.shape == (18, 24, 3) and png.std() > 5
    assert np.array_equal(png, expected)
    assert np.array_equal(cli.quantize(img), expected)
