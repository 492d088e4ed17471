"""Host times of the port's readers beside PIL's decode of the same files,
on the machine this runs on (PIL where it is installed):

    PYTHONPATH=. python tests/readers_timing.py

- the C unfilter alone (`png_unfilter` through ctypes) on a 540x960 RGB
  stream of random bytes, every row one filter type;
- `read_png` (C and the numpy plain version) and PIL on a 540x960 RGB
  texture written by `write_png` None- and Paeth-filtered;
- `read_jpeg` and PIL on the committed 540x960 JPEG
  (`tests/data/jpeg/stereo.left.jpg`).

Best and median ms of REPS calls after one warm-up call.  Not a test.
"""

import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from anystereo_tpu_torch.data import png  # noqa: E402
from anystereo_tpu_torch.data.jpeg import read_jpeg  # noqa: E402

REPS = 20


def _ms(fn):
    fn()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return f"{times[0]:.2f} (median {times[len(times) // 2]:.2f})"


def main():
    try:
        from PIL import Image
    except ImportError:
        Image = None
    h, w, bpp = 540, 960, 3
    raw = np.random.RandomState(0).randint(0, 256, (h, w * bpp + 1)).astype(np.uint8)
    for kind in range(5):
        raw[:, 0] = kind
        stream = raw.reshape(-1)
        print(f"C unfilter alone, filter {kind}: {_ms(lambda: png._unfilter_c(stream, h, w * bpp, bpp))}")
    from scipy.ndimage import gaussian_filter

    x = gaussian_filter(np.random.RandomState(1).rand(h, w, 3), (1.2, 1.2, 0))
    img = ((x - x.min()) / (x.max() - x.min()) * 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        for name, kind in (("None", 0), ("Paeth", 4)):
            p = os.path.join(d, f"{name}.png")
            png.write_png(p, img, filter_type=kind)
            line = (f"read_png 540x960 RGB {name}: C {_ms(lambda: png.read_png(p))}, numpy "
                    f"{_ms(lambda: png.read_png(p, impl='numpy'))}")
            if Image is not None:
                line += f", PIL {_ms(lambda: np.array(Image.open(p)))}"
            print(line)
    jpg = os.path.join(ROOT, "tests", "data", "jpeg", "stereo.left.jpg")
    line = f"540x960 JPEG ({os.path.getsize(jpg)} bytes): C {_ms(lambda: read_jpeg(jpg))}"
    if Image is not None:
        line += f", PIL {_ms(lambda: np.array(Image.open(jpg)))}"
    print(line)


if __name__ == "__main__":
    main()
