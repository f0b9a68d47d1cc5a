"""Novel-view-synthesis benchmark wrapper (Nerfstudio CLI orchestration).

Counterpart of acezero_tpu/export/nerfstudio_runner.py (the reference
benchmarks/run_benchmark.py + run_nerfstudio.py): convert an ACE pose file
to transforms.json, cap the test set and downscale the images to at most
640 pixels a side, shell out to `ns-train nerfacto|splatfacto` and
`ns-eval`, and collect PSNR/SSIM/LPIPS from eval.json. Nerfstudio is an
external dependency that this module never installs; without its CLIs it
raises RuntimeError naming the missing one.

The downscale is what the JAX runner's `Image.open(src).resize(size,
BILINEAR)` gives for any source the port reads, in the mode PIL opens it in
(io/formats.py::pil_mode), written under the source's name as its
`img.save(dst)` writes it, the format picked by the suffix: a JPEG by
io/jpeg.py (PIL's default quality 75 and sampling, PIL's bytes), a TIFF by
io/tiff.py (uncompressed, as PIL's default), a BMP by io/bmp.py (PIL's
bytes), a PBM/PGM/PPM/PFM by io/pnm.py (PIL's bytes), a WebP by
io/webp.py (lossless, see below), a GIF by io/gif.py (mode P or L, its
palette and transparency index as PIL's save remaps them, so that it reads
back as PIL's own file does; other bytes), a JPEG 2000 by io/jpeg2000.py
(lossless 5/3, a bare codestream for `.j2k` and JP2 boxes for the other
suffixes, as PIL's save picks; it reads back as PIL's own lossless file
does; other bytes), a TGA by io/tga.py (PIL's bytes, raw or run-length,
its rows' order and ID section those of a TGA source, as PIL's `info`
carries them through the resize into the save), an SGI by io/sgi.py, a PCX
by io/pcx.py and a QOI by io/qoi.py (PIL's bytes), a PNG by io/png.py
(PIL's mode and pixels, other bytes); a suffix the port has no writer for
raises OSError (PIL raises for a suffix it does not know, and writes the
other formats it knows, but for Sun raster and DCX, which it only reads:
there it raises KeyError). Modes L, RGB and CMYK take Pillow's
8-bit bilinear resize (data/images.py::pil_resize_bilinear), I;16 and
I;16B its 16-bit one (I;16B's bytes taken in the wrong order, as Pillow
takes them on a little-endian host), I and F its 32-bit one; LA and RGBA are
premultiplied by alpha, resized and unpremultiplied, as Pillow does;
16-bit colour is first made 8-bit as PIL opens it (`pil_uint8`). Modes P
and 1 take Pillow's nearest-neighbour resize, on the palette indices or
booleans (the palette kept); a JPEG 2000's PA its 8-bit bilinear resize
of the indices and the alpha band, as Pillow resizes PA. A GIF's transparency index goes with the
image, as `info["transparency"]` goes with PIL's resize; a GIF of mode L
that keeps a global palette under a local grey ramp, or a TGA of mode L or
LA over a colour map, raises ValueError, as PIL's BILINEAR resize of it
does. A mode the format cannot hold raises
OSError, as PIL's save does.

PIL's save of a TIFF it opened keeps the source's compression. The port
writes every TIFF uncompressed, which PIL reads back to the same mode and
pixels but in two cases: an I;16B image that libtiff writes (the source
LZW, Deflate or PackBits) reads back as I;16, so the port writes I;16
there; and a JPEG-compressed source, which PIL compresses again with
libtiff's JPEG encoder, loses what that loses, and the port's uncompressed
file keeps it (ROADMAP.md records the difference). A WebP source (mode
RGB or RGBA) is written as a lossless VP8L file whose alpha bit follows the
mode, so it reads back in the source's mode as PIL's resize exactly; PIL's
save writes lossy VP8 at quality 80, whose read-back differs from its
resize by that loss (the second recorded difference).
"""

from __future__ import annotations

import json
import logging
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from acezero_tpu_torch.data.images import (
    CmykImage,
    ModeImage,
    pil_array,
    pil_premultiply,
    pil_resize_bilinear,
    pil_resize_nearest,
    pil_uint8,
    pil_unpremultiply,
    read_image,
)
from acezero_tpu_torch.export.nerf import export_transforms_json
from acezero_tpu_torch.io import tga, tiff
from acezero_tpu_torch.io.bmp import write_bmp
from acezero_tpu_torch.io.gif import write_gif
from acezero_tpu_torch.io.formats import file_kind, image_size, pil_mode
from acezero_tpu_torch.io.jpeg import write_jpeg
from acezero_tpu_torch.io.jpeg2000 import SAVE_MODES as JPEG2000_MODES
from acezero_tpu_torch.io.jpeg2000 import write_jpeg2000
from acezero_tpu_torch.io.pcx import write_pcx
from acezero_tpu_torch.io.png import write_png
from acezero_tpu_torch.io.pnm import write_pnm
from acezero_tpu_torch.io.qoi import write_qoi
from acezero_tpu_torch.io.sgi import SUFFIXES as SGI_SUFFIXES
from acezero_tpu_torch.io.sgi import write_sgi
from acezero_tpu_torch.io.webp import write_webp

_logger = logging.getLogger(__name__)

MAX_TEST_IMAGES = 1000  # reference run_benchmark.py:96-114
MAX_IMAGE_SIDE = 640  # reference auto-downscales to <=640 px
PRELOAD_MAX_FRAMES = 3500  # preload-to-GPU heuristic, run_benchmark.py:244-252
JPEG_SUFFIXES = (".jpg", ".jpeg", ".jpe", ".jfif")  # PIL picks the format to save by the name
JPEG_MODES = ("1", "L", "RGB", "CMYK")  # the modes that PIL saves as JPEG (1 as gray of 0 and 255)
TIFF_SUFFIXES = (".tif", ".tiff")
PNM_SUFFIXES = (".pbm", ".pgm", ".ppm", ".pnm", ".pfm")
PNG_SUFFIXES = (".png", ".apng")
JPEG2000_SUFFIXES = (".jp2", ".j2k", ".jpc", ".jpf", ".jpx", ".j2c")
_LIBTIFF_WRITES = (tiff.LZW, tiff.PACKBITS, *tiff.DEFLATE)  # compressions PIL's save hands to libtiff


@dataclass
class NerfBenchmarkConfig:
    method: str = "nerfacto"  # nerfacto | splatfacto
    downscale: bool = True
    max_test_images: int = MAX_TEST_IMAGES
    extra_train_args: tuple = ()


def _require_cli(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(
            f"`{name}` not found on PATH. The view-synthesis benchmark needs a "
            "Nerfstudio installation (the reference runs it in a dedicated "
            "conda environment, scripts/reconstruct_7scenes.sh)."
        )
    return path


def _resized(src: Path, new_w: int, new_h: int) -> tuple[np.ndarray, str, np.ndarray | None, int | None]:
    """PIL's `Image.open(src).resize((new_w, new_h), BILINEAR)`: its pixels
    (module note), the mode PIL opened the file in, the palette of a mode-P
    image (None otherwise) and a GIF's transparency index (None
    otherwise)."""
    mode = pil_mode(src)
    img = read_image(src)
    palette = img.palette if isinstance(img, ModeImage) else None
    transparency = img.transparency if isinstance(img, ModeImage) else None
    if mode in ("P", "1"):  # Pillow resizes these nearest-neighbour whatever filter is asked for
        return pil_resize_nearest(pil_array(img), new_h, new_w), mode, palette, transparency
    if mode in ("L", "LA") and palette is not None:
        raise ValueError(f"{src}: image has wrong mode (mode {mode} over a palette, as PIL's resize says)")
    if mode == "PA":  # Pillow resamples the index and alpha bands as bytes
        return pil_resize_bilinear(img.pixels, new_h, new_w), mode, palette, None
    if mode == "I;16B":  # Pillow resamples the big-endian samples as little-endian ones
        out = pil_resize_bilinear(img.pixels.byteswap(), new_h, new_w).byteswap()
        if src.suffix.lower() in TIFF_SUFFIXES and tiff.tiff_compression(src) in _LIBTIFF_WRITES:
            mode = "I;16"  # libtiff's file of it reads back as I;16
        return out, mode, None, None
    if isinstance(img, CmykImage):
        img = img.pixels
    elif mode not in ("I;16", "I", "F"):  # 16-bit colour opens as 8-bit
        img = pil_uint8(img)
    if mode == "RGBA" and img.shape[2] == 2:  # 16-bit gray+alpha opens as RGBA
        img = img[..., [0, 0, 0, 1]]
    if mode in ("LA", "RGBA"):
        return pil_unpremultiply(pil_resize_bilinear(pil_premultiply(img), new_h, new_w)), mode, None, None
    return pil_resize_bilinear(img, new_h, new_w), mode, None, transparency


def _save(dst: Path, img: np.ndarray, mode: str, palette: np.ndarray | None = None,
          transparency: int | None = None, info: dict | None = None) -> None:
    """PIL's `img.save(dst)` of an image of `mode` (with `info["transparency"]`
    = `transparency`, and a TGA source's `info`: tga.TgaHeader.info), its
    format picked by the name: a JPEG, TIFF, BMP, PBM/PGM/PPM/PFM, WebP
    (lossless RGB or RGBA, where PIL writes lossy VP8: module note), GIF,
    JPEG 2000, TGA, SGI, PCX, QOI or PNG for their suffixes; any other
    suffix raises OSError."""
    suffix = dst.suffix.lower()
    info = info or {}
    if suffix in JPEG_SUFFIXES:
        if mode not in JPEG_MODES:
            raise OSError(f"cannot write mode {mode} as JPEG")
        write_jpeg(dst, img)
    elif suffix in TIFF_SUFFIXES:
        tiff.write_tiff(dst, img, mode, palette)
    elif suffix == ".bmp":
        write_bmp(dst, img, mode, palette)
    elif suffix in PNM_SUFFIXES:
        write_pnm(dst, img, mode)
    elif suffix == ".webp":
        if mode not in ("RGB", "RGBA"):
            raise OSError(f"cannot write mode {mode} as WebP")
        write_webp(dst, img)
    elif suffix == ".gif":
        write_gif(dst, img, mode, palette, transparency)
    elif suffix in JPEG2000_SUFFIXES:
        mode = "I;16" if mode == "I;16B" else mode  # PIL saves I;16B's values as I;16
        if mode not in JPEG2000_MODES:
            raise OSError(f"cannot write mode {mode} as JPEG 2000")
        write_jpeg2000(dst, img, mode)
    elif suffix in tga.SUFFIXES:
        tga.write_tga(dst, img, mode, palette, info.get("compression"), info.get("orientation", -1),
                      info.get("id_section", b""))
    elif suffix in SGI_SUFFIXES:
        write_sgi(dst, img, mode)
    elif suffix == ".pcx":
        write_pcx(dst, img, mode, palette)
    elif suffix == ".qoi":
        write_qoi(dst, img, mode)
    elif suffix in PNG_SUFFIXES:
        write_png(dst, img, palette)
    else:
        raise OSError(f"{dst}: the port writes no image format of suffix {suffix!r}")


def _downscale_images(transforms_path: Path, workdir: Path) -> None:
    with open(transforms_path) as f:
        transforms = json.load(f)
    img_dir = workdir / "images_downscaled"
    img_dir.mkdir(exist_ok=True)
    for frame in transforms["frames"]:
        src = Path(frame["file_path"])
        width, height = image_size(src)
        scale = MAX_IMAGE_SIDE / max(width, height)
        if scale >= 1.0:
            continue
        new_size = (round(width * scale), round(height * scale))
        dst = img_dir / src.name
        info = tga.tga_header(src).info if file_kind(src) == "tga" else None
        _save(dst, *_resized(src, *new_size), info=info)
        for key, factor in (("fl_x", scale), ("fl_y", scale), ("cx", scale), ("cy", scale)):
            frame[key] = frame[key] * factor
        frame["w"], frame["h"] = new_size
        # update filename references in splits
        for split_key in ("train_filenames", "test_filenames"):
            transforms[split_key] = [str(dst) if f == frame["file_path"] else f for f in transforms[split_key]]
        frame["file_path"] = str(dst)
    with open(transforms_path, "w") as f:
        json.dump(transforms, f)


def run_benchmark(
    pose_file: str | Path,
    images_glob_pattern: str,
    output_dir: str | Path,
    cfg: NerfBenchmarkConfig = NerfBenchmarkConfig(),
    split_file: str | Path | None = None,
) -> dict:
    """Full benchmark: convert -> ns-train -> ns-eval -> metrics dict."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    transforms_path = export_transforms_json(pose_file, images_glob_pattern, output_dir, split_file=split_file)

    with open(transforms_path) as f:
        transforms = json.load(f)
    if len(transforms["test_filenames"]) > cfg.max_test_images:
        transforms["test_filenames"] = transforms["test_filenames"][: cfg.max_test_images]
        with open(transforms_path, "w") as f:
            json.dump(transforms, f)

    if cfg.downscale:
        _downscale_images(transforms_path, output_dir)

    ns_train = _require_cli("ns-train")
    ns_eval = _require_cli("ns-eval")

    n_frames = len(transforms["frames"])
    train_cmd = [
        ns_train,
        cfg.method,
        "--data", str(output_dir),
        "--output-dir", str(output_dir / "runs"),
        "--experiment-name", cfg.method,
        "--timestamp", "run",
        "--viewer.quit-on-train-completion", "True",
        "--pipeline.datamanager.images-on-gpu",
        "True" if n_frames <= PRELOAD_MAX_FRAMES else "False",
        *cfg.extra_train_args,
        "nerfstudio-data",
        "--eval-mode", "filename",
    ]
    _logger.info("Running: %s", " ".join(train_cmd))
    subprocess.run(train_cmd, check=True)

    run_dir = output_dir / "runs" / cfg.method / cfg.method / "run"
    eval_json = run_dir / "eval.json"
    eval_cmd = [ns_eval, "--load-config", str(run_dir / "config.yml"), "--output-path", str(eval_json)]
    _logger.info("Running: %s", " ".join(eval_cmd))
    subprocess.run(eval_cmd, check=True)

    with open(eval_json) as f:
        results = json.load(f)["results"]
    _logger.info("Benchmark %s: psnr %.2f ssim %.3f lpips %.3f", cfg.method, results.get("psnr", -1),
                 results.get("ssim", -1), results.get("lpips", -1))
    return results


def collect_results(results_root: str | Path) -> dict[str, dict]:
    """Walk scene subfolders and collect eval.json metrics (the reference
    scripts/show_benchmark_results.py behavior)."""
    out = {}
    for eval_json in sorted(Path(results_root).glob("**/eval.json")):
        with open(eval_json) as f:
            out[str(eval_json.parent)] = json.load(f).get("results", {})
    return out
