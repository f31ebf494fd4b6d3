"""On-device data augmentation, batched over B.  Port of
``vaeunet_tpu/data/augment.py`` (the reference train-split policy,
utils/data_loading.py:116-180):

  HFlip p=.5 | VFlip p=.5 | Rot90 p=.5
  OneOf{CLAHE(clip 1.5-4, 8x8 tiles), RandomGamma(80,120)} p=.5
  OneOf{BrightnessContrast(+-.1), ColorJitter(.1,.1,.1,0)} p=.3
  Affine(scale .9-1.1, translate +-6.25%, rotate +-15deg, cval=0) p=.3
  GaussNoise(per-channel) p=.2
  OneOf{GaussianBlur(3-5), MotionBlur(3-5)} p=.2
  GridDistortion(5 steps, +-.1, reflect101) p=.2

Each transform is split into a *draw* and an *apply*.  :func:`draw_params`
takes every flag and parameter of a batch from one CPU ``torch.Generator``
as a [B, 38] table (:data:`COLUMNS`); :func:`params_to` moves the table to
the device in one copy.  The ``apply_*`` functions are pure functions of
their parameters on any device, so the tests feed them the very parameters
``jax.random`` drew for the JAX transforms.  As in the JAX package every
branch is computed for every sample and ``torch.where`` selects per sample:
no Python branch on a device value, no host sync.  The Gauss noise is one
``ops/sampling.py::gaussian_like`` draw of [B, H, W, 3] a batch, whatever
the flags say.

Every division by a constant is a true division (``device.true_div``), as
JAX's and the CPU's are: CUDA multiplies by the reciprocal otherwise.
Where JAX rounds to bf16, the port rounds at the same place:
- the affine warp (two passes, Catmull-Smith) runs as two gathers and a
  lerp per pass, not as JAX's dense [W, H, H] interpolation matmuls; its
  weights, the image and the intermediate are bf16, the products exact in
  fp32, so each output is the one rounding of the same two-term sum.  The
  warp runs for every sample: at the identity it rounds the image to bf16,
  as JAX's does;
- CLAHE's 3x3-neighbour LUT stack is bf16 (``augment.py:287``); the
  histograms are integer counts (``scatter_add_``) and the LUT is applied
  by gathers.

Images are float32 [B,H,W,3] in [0,1]; masks [B,H,W,C] {0,1}.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vaeunet_tpu_torch.device import host_to_device, true_div
from vaeunet_tpu_torch.ops.sampling import gaussian_like

GRID_STEPS = 5
CLAHE_TILES, CLAHE_BINS = 8, 256

# name -> width of its columns in the parameter table, in the order drawn.
# Flags are 0/1, integers are whole floats, the rest the drawn values.
COLUMNS: Tuple[Tuple[str, int], ...] = (
    ("do_h", 1), ("do_v", 1), ("rot_k", 1),                               # flips
    ("contrast", 1), ("use_clahe", 1), ("clip", 1), ("gamma", 1),         # p .5
    ("color", 1), ("use_bc", 1), ("alpha", 1), ("beta", 1),               # p .3
    ("jit_b", 1), ("jit_c", 1), ("jit_s", 1),
    ("affine", 1), ("scale", 1), ("tx", 1), ("ty", 1), ("theta", 1),      # p .3
    ("noise", 1), ("var", 1),                                             # p .2
    ("blur", 1), ("use_gauss", 1), ("use5", 1), ("direction", 1),         # p .2
    ("grid", 1), ("grid_x", GRID_STEPS + 1), ("grid_y", GRID_STEPS + 1),  # p .2
)
WIDTH = sum(w for _, w in COLUMNS)


# -------------------------------------------------------------------- draw

def draw_params(generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
    """Every flag and parameter of the policy for `batch` samples, from one
    [B, WIDTH + 1] block of uniforms on the generator's device (the CPU for
    a train state's generator; the rotation's flag and its k share a
    column): {name: [B] or [B, k] float32}."""
    u = torch.rand((batch, WIDTH + 1), generator=generator, device=generator.device)
    cols = iter(u.unbind(1))

    def nxt():
        return next(cols)

    def flag(p: float) -> torch.Tensor:
        return (nxt() < p).float()

    def unif(lo: float, hi: float, n: int = 0) -> torch.Tensor:
        if n:
            return torch.stack([lo + (hi - lo) * nxt() for _ in range(n)], 1)
        return lo + (hi - lo) * nxt()

    def randint(n: int) -> torch.Tensor:
        return torch.clamp(torch.floor(nxt() * n), max=n - 1)

    out: Dict[str, torch.Tensor] = {}
    out["do_h"], out["do_v"] = flag(0.5), flag(0.5)
    do_r, k = flag(0.5), randint(4)
    out["rot_k"] = k * do_r
    out["contrast"], out["use_clahe"] = flag(0.5), flag(0.5)
    out["clip"], out["gamma"] = unif(1.5, 4.0), unif(0.8, 1.2)
    out["color"], out["use_bc"] = flag(0.3), flag(0.5)
    out["alpha"], out["beta"] = unif(-0.1, 0.1), unif(-0.1, 0.1)
    out["jit_b"], out["jit_c"], out["jit_s"] = unif(0.9, 1.1), unif(0.9, 1.1), unif(0.9, 1.1)
    out["affine"], out["scale"] = flag(0.3), unif(0.9, 1.1)
    out["tx"], out["ty"] = unif(-0.0625, 0.0625), unif(-0.0625, 0.0625)
    out["theta"] = unif(-15.0, 15.0)
    out["noise"], out["var"] = flag(0.2), unif(10.0, 50.0)
    out["blur"], out["use_gauss"], out["use5"] = flag(0.2), flag(0.5), flag(0.5)
    out["direction"] = randint(4)
    out["grid"] = flag(0.2)
    out["grid_x"] = unif(-0.1, 0.1, GRID_STEPS + 1)
    out["grid_y"] = unif(-0.1, 0.1, GRID_STEPS + 1)
    return out


def params_to(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """The parameter table on `device` in one copy that does not wait for
    the device, split back by name."""
    b = next(iter(params.values())).shape[0]
    table = host_to_device(torch.cat([params[n].reshape(b, w) for n, w in COLUMNS], 1),
                           torch.device(device))
    parts = table.split([w for _, w in COLUMNS], 1)
    return {n: (p[:, 0] if w == 1 else p) for (n, w), p in zip(COLUMNS, parts)}


def _sel(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sample ``where`` of [B] flags over [B, ...] tensors."""
    return torch.where(flag.bool().reshape(-1, *([1] * (a.dim() - 1))), a, b)


def _per(x: torch.Tensor, dims: int = 3) -> torch.Tensor:
    """[B] -> [B, 1, ..., 1] for broadcasting over `dims` trailing axes."""
    return x.reshape(-1, *([1] * dims))


# ---------------------------------------------------------------- geometric

def apply_flips(img: torch.Tensor, mask: torch.Tensor, do_h, do_v, rot_k):
    """HFlip, then VFlip, then rot90 k times (counter-clockwise, as
    ``jnp.rot90``; square images only, as in JAX), composed into one index
    map per sample and one gather each for image and mask."""
    b, h, w = img.shape[:3]
    dev = img.device
    i = torch.arange(h, device=dev).view(1, h, 1).expand(b, h, w)
    j = torch.arange(w, device=dev).view(1, 1, w).expand(b, h, w)
    ys, xs = i, j
    if h == w:
        k = _per(rot_k.long(), 2)
        n1 = h - 1
        # rot90(a, k)[i, j] = a[src]: k=1 (j, n-i), k=2 (n-i, n-j), k=3 (n-j, i)
        ys = torch.where(k == 1, j, torch.where(k == 2, n1 - i, torch.where(k == 3, n1 - j, i)))
        xs = torch.where(k == 1, n1 - i, torch.where(k == 2, n1 - j, torch.where(k == 3, i, j)))
    ys = torch.where(_per(do_v, 2).bool(), h - 1 - ys, ys)
    xs = torch.where(_per(do_h, 2).bool(), w - 1 - xs, xs)
    flat = (ys * w + xs).reshape(b, h * w, 1)

    def take(x):
        c = x.shape[-1]
        return torch.gather(x.reshape(b, h * w, c), 1, flat.expand(b, h * w, c)).view(b, h, w, c)

    return take(img), take(mask)


def _axis_taps(src: torch.Tensor, size: int, nearest: bool):
    """The nonzero entries of a row of JAX's ``_axis_interp_matrix``:
    (index0, weight0, index1, weight1), weights bf16 as JAX casts them and
    zero out of range (fill 0); indices clamped into the axis."""
    if nearest:
        r = torch.round(src)
        ok = (src >= -0.5) & (src <= size - 0.5) & (r >= 0) & (r <= size - 1)
        w0 = ok.to(torch.bfloat16)
        i0 = r.clamp(0, size - 1).long()
        return i0, w0, i0, torch.zeros_like(w0)
    s0 = torch.floor(src)
    f = src - s0
    inb = ((src >= 0) & (src <= size - 1)).to(torch.bfloat16)
    w0 = (1.0 - f).to(torch.bfloat16) * inb
    # grid position s0 + 1 is on the axis only below size - 1 (at size - 1, f = 0)
    w1 = f.to(torch.bfloat16) * inb * (s0 + 1 <= size - 1).to(torch.bfloat16)
    i0 = s0.clamp(0, size - 1).long()
    i1 = (s0 + 1).clamp(0, size - 1).long()
    return i0, w0, i1, w1


def _lerp_gather(x: torch.Tensor, dim: int, taps) -> torch.Tensor:
    """sum_t w_t * x[..., i_t, ...] along `dim` (1 or 2) of bf16 [B,H,W,C]
    with [B,H,W] taps: bf16 products are exact in fp32, so this is the one
    fp32 rounding of JAX's einsum row."""
    i0, w0, i1, w1 = taps
    c = x.shape[-1]

    def g(i):
        return torch.gather(x, dim, i.unsqueeze(-1).expand(*i.shape, c)).float()

    return w0.float().unsqueeze(-1) * g(i0) + w1.float().unsqueeze(-1) * g(i1)


def apply_affine(img: torch.Tensor, mask: torch.Tensor, apply, scale, tx, ty, theta):
    """Affine(scale, translate tx*W / ty*H, rotate theta degrees, fill 0) by
    the two-pass warp of ``augment.py:132-188``: rows of each column at
    Y'(v, x), then columns of each row at X(y, x); identity where `apply`
    is 0.  The mask takes nearest-then-nearest and > 0.5."""
    b, h, w = img.shape[:3]
    dev = img.device
    apply = apply.bool()
    scale = torch.where(apply, scale, torch.ones_like(scale))
    tx = torch.where(apply, tx * w, torch.zeros_like(tx))
    ty = torch.where(apply, ty * h, torch.zeros_like(ty))
    # jnp.deg2rad: times pi/180 rounded to fp32 (new_full: no host copy)
    theta = torch.where(apply, theta * theta.new_full((), math.pi / 180), torch.zeros_like(theta))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    # cos and sin rounded from fp64: nearer XLA's fp32 results than torch's fp32 ones
    cos, sin = torch.cos(theta.double()).float(), torch.sin(theta.double()).float()
    inv = 1.0 / scale
    a_, b_ = inv * cos, inv * sin
    c_, d_ = -inv * sin, inv * cos
    e_ = cy - a_ * (cy + ty) - b_ * (cx + tx)
    f_ = cx - c_ * (cy + ty) - d_ * (cx + tx)
    a_, b_, c_, d_, e_, f_ = (_per(t, 2) for t in (a_, b_, c_, d_, e_, f_))
    vv = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    yprime = a_ * vv + (b_ / d_) * (xx - c_ * vv - f_) + e_     # [B, H(v), W(x)]
    xsrc = c_ * vv + d_ * xx + f_                                # [B, H(y), W(o)]

    def warp(x, nearest):
        tmp = _lerp_gather(x.to(torch.bfloat16), 1, _axis_taps(yprime, h, nearest))
        return _lerp_gather(tmp.to(torch.bfloat16), 2, _axis_taps(xsrc, w, nearest))

    img = warp(img, False)
    mask = (warp(mask, True) > 0.5).to(img.dtype)
    return img, mask


def _reflect101(coords: torch.Tensor, size: int) -> torch.Tensor:
    period = 2 * (size - 1)
    c = torch.fmod(torch.abs(coords), period)
    return torch.where(c > size - 1, period - c, c)


def _axis_map(size: int, steps: torch.Tensor) -> torch.Tensor:
    """[B, size] source coordinate of each output pixel along one axis
    (``augment.py:206-224``); `steps` [B, GRID_STEPS + 1]."""
    b = steps.shape[0]
    dev = steps.device
    step = size // GRID_STEPS
    widths = torch.full((GRID_STEPS,), float(step), device=dev) * steps[:, :GRID_STEPS]
    # the running sum in fp32, left to right as XLA's cumsum (torch.cumsum of
    # fp32 on the CPU accumulates in fp64)
    bounds = [torch.zeros((b,), device=dev), widths[:, 0]]
    for k in range(1, GRID_STEPS):
        bounds.append(bounds[-1] + widths[:, k])
    bounds = torch.stack(bounds, 1)
    # a true division: `scalar / tensor` in torch multiplies by the reciprocal
    last = torch.clamp(bounds[:, -1:], min=1e-6)
    bounds = bounds * (torch.full_like(last, size - 1) / last)
    # jnp.linspace(0, size - 1, 6): stop * (k / 5) for k < 5, then stop itself
    frac_k = true_div(torch.arange(GRID_STEPS, dtype=torch.float32, device=dev), GRID_STEPS)
    src_cell = torch.cat([(size - 1) * frac_k,
                          torch.full((1,), float(size - 1), device=dev)])
    out_pix = torch.arange(size, dtype=torch.float32, device=dev).expand(b, size).contiguous()
    idx = torch.clamp(torch.searchsorted(bounds, out_pix, right=True) - 1, 0, GRID_STEPS - 1)
    b0 = torch.gather(bounds, 1, idx)
    b1 = torch.gather(bounds, 1, idx + 1)
    frac = (out_pix - b0) / torch.clamp(b1 - b0, min=1e-6)
    return src_cell[idx] + frac * (src_cell[idx + 1] - src_cell[idx])


def _resample_rows_cols(x: torch.Tensor, map_y: torch.Tensor, map_x: torch.Tensor,
                        nearest: bool) -> torch.Tensor:
    """Separable resample of [B,H,W,C] at per-axis source coordinates
    (reflect-101), rows first: two gathers."""
    b, h, w, c = x.shape
    ys = _reflect101(map_y, h)
    xs = _reflect101(map_x, w)

    def rows(src, i):
        return torch.gather(src, 1, i.view(b, h, 1, 1).expand(b, h, w, c))

    def cols(src, i):
        return torch.gather(src, 2, i.view(b, 1, w, 1).expand(b, h, w, c))

    if nearest:
        yi = torch.clamp(torch.round(ys).int(), 0, h - 1).long()
        xi = torch.clamp(torch.round(xs).int(), 0, w - 1).long()
        return cols(rows(x, yi), xi)
    y0 = torch.clamp(torch.floor(ys).int(), 0, h - 1).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fy = (ys - y0).view(b, h, 1, 1)
    x_rows = rows(x, y0) * (1 - fy) + rows(x, y1) * fy
    x0 = torch.clamp(torch.floor(xs).int(), 0, w - 1).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fx = (xs - x0).view(b, 1, w, 1)
    return cols(x_rows, x0) * (1 - fx) + cols(x_rows, x1) * fx


def apply_grid(img: torch.Tensor, mask: torch.Tensor, apply, grid_x, grid_y):
    """GridDistortion: per-cell axis stretching 1 + grid_* (first 5 of 6
    used, as JAX), reflect-101 border; identity where `apply` is 0."""
    h, w = img.shape[1:3]
    one = torch.ones_like(grid_x)
    sx = _sel(apply, 1 + grid_x, one)
    sy = _sel(apply, 1 + grid_y, one)
    map_y = _axis_map(h, sy)
    map_x = _axis_map(w, sx)
    return (_resample_rows_cols(img, map_y, map_x, nearest=False),
            _resample_rows_cols(mask, map_y, map_x, nearest=True))


# -------------------------------------------------------------- photometric

def _luma(img: torch.Tensor) -> torch.Tensor:
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def _clahe_axis_weights(tile_len: int, device) -> torch.Tensor:
    """[TILES * tile_len, 3] weights of each row (or column) over its tile's
    3-neighbourhood slots (``augment.py:294-306``)."""
    tiles = CLAHE_TILES
    n = tiles * tile_len
    pos = true_div(torch.arange(n, dtype=torch.float32, device=device) + 0.5, tile_len) - 0.5
    i = torch.arange(n, device=device) // tile_len
    p0 = torch.clamp(torch.floor(pos).int(), 0, tiles - 1)
    p1 = torch.clamp(p0 + 1, max=tiles - 1)
    f = torch.clamp(pos - p0, 0, 1)
    a0 = (p0 - i + 1).unsqueeze(1)
    a1 = (p1 - i + 1).unsqueeze(1)
    slots = torch.arange(3, device=device)
    return ((a0 == slots) * (1 - f).unsqueeze(1) + (a1 == slots) * f.unsqueeze(1)).float()


def clahe(img: torch.Tensor, clip_limit: torch.Tensor) -> torch.Tensor:
    """CLAHE on the luma, fixed 8x8 tile grid (``augment.py:252-314``):
    histograms by ``scatter_add_`` (exact counts), clip and redistribute, the
    CDF as LUT, bilinear between the four nearest tiles' LUTs, the image
    scaled by new / old luma.  `clip_limit` [B]."""
    b, h, w = img.shape[:3]
    dev = img.device
    tiles, bins = CLAHE_TILES, CLAHE_BINS
    th, tw = -(-h // tiles), -(-w // tiles)
    ph, pw = th * tiles - h, tw * tiles - w
    lum = _luma(img)
    lum_p = F.pad(lum.unsqueeze(1), (0, pw, 0, ph), mode="replicate").squeeze(1)
    q = torch.clamp((lum_p * (bins - 1)).int(), 0, bins - 1).long()       # [B, Hp, Wp]
    tile_of = (torch.arange(tiles * th, device=dev) // th).view(1, -1, 1) * tiles \
        + (torch.arange(tiles * tw, device=dev) // tw).view(1, 1, -1)
    bucket = (torch.arange(b, device=dev).view(-1, 1, 1) * (tiles * tiles) + tile_of) * bins + q
    # integer counts by scatter_add into a known size (bincount on CUDA
    # reads its input's max back to the host)
    hist = torch.zeros(b * tiles * tiles * bins, dtype=torch.int32, device=dev)
    hist.scatter_add_(0, bucket.reshape(-1), torch.ones_like(bucket, dtype=torch.int32).reshape(-1))
    hist = hist.view(b, tiles * tiles, bins).float()
    clip = _per(true_div(clip_limit * (th * tw), bins), 2)
    excess = torch.sum(torch.clamp(hist - clip, min=0), dim=2, keepdim=True)
    hist = torch.minimum(hist, clip) + true_div(excess, bins)
    cdf = torch.cumsum(hist, dim=2)
    cdf = (cdf - cdf[..., :1]) / torch.clamp(cdf[..., -1:] - cdf[..., :1], min=1e-6)
    # the LUT stack of augment.py:284-287 rounds to bf16
    lut = cdf.to(torch.bfloat16).float().reshape(b, tiles * tiles * bins)

    wy = _clahe_axis_weights(th, dev)                  # [Hp, 3]
    wx = _clahe_axis_weights(tw, dev)                  # [Wp, 3]
    ti = torch.arange(tiles * th, device=dev) // th
    tj = torch.arange(tiles * tw, device=dev) // tw
    out = None
    for a in range(3):
        row_tile = torch.clamp(ti + a - 1, 0, tiles - 1).view(1, -1, 1)
        acc = None
        for c in range(3):
            col_tile = torch.clamp(tj + c - 1, 0, tiles - 1).view(1, 1, -1)
            cand = torch.gather(lut, 1, ((row_tile * tiles + col_tile) * bins + q).view(b, -1))
            term = cand.view_as(lum_p) * wx[:, c].view(1, 1, -1)
            acc = term if acc is None else acc + term
        term = acc * wy[:, a].view(1, -1, 1)
        out = term if out is None else out + term
    new_lum = out[:, :h, :w]
    ratio = new_lum / torch.clamp(lum, min=1e-6)
    return torch.clamp(img * ratio.unsqueeze(-1), 0.0, 1.0)


def apply_contrast(img: torch.Tensor, apply, use_clahe, clip, gamma) -> torch.Tensor:
    """OneOf{CLAHE, RandomGamma}."""
    gamma_img = torch.pow(torch.clamp(img, min=1e-8), _per(gamma))
    out = _sel(use_clahe, clahe(img, clip), gamma_img)
    return _sel(apply, out, img)


def apply_color(img: torch.Tensor, apply, use_bc, alpha, beta, jit_b, jit_c, jit_s):
    """OneOf{RandomBrightnessContrast(.1,.1), ColorJitter(.1,.1,.1,0)}."""
    bc = torch.clamp(img * (1 + _per(alpha)) + _per(beta), 0, 1)
    cj = torch.clamp(img * _per(jit_b), 0, 1)
    mean_gray = _per(torch.mean(_luma(cj), dim=(1, 2)))
    cj = torch.clamp(mean_gray + (cj - mean_gray) * _per(jit_c), 0, 1)
    gray = _luma(cj).unsqueeze(-1)
    cj = torch.clamp(gray + (cj - gray) * _per(jit_s), 0, 1)
    return _sel(apply, _sel(use_bc, bc, cj), img)


def apply_noise(img: torch.Tensor, apply, var, eps: torch.Tensor) -> torch.Tensor:
    """GaussNoise: var in 0-255 units, eps [B,H,W,3] ~ N(0, 1)."""
    std = true_div(torch.sqrt(var), 255.0)
    return _sel(apply, torch.clamp(img + eps * _per(std), 0, 1), img)


def _gaussian_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2
    k = torch.exp(-0.5 * torch.square(true_div(x, sigma)))
    return k / torch.sum(k)


def blur_kernels(use_gauss, use5, direction) -> torch.Tensor:
    """[B, 5, 5] kernels of ``augment.py:367-402``: Gaussian 5x5 or its 3x3
    zero-padded (cv2's sigma rule), or a motion line of length 5 or 3 in one
    of 4 directions, normalized."""
    dev = use_gauss.device
    sigma3 = 0.3 * ((3 - 1) * 0.5 - 1) + 0.8
    sigma5 = 0.3 * ((5 - 1) * 0.5 - 1) + 0.8
    g3p = F.pad(_gaussian_kernel1d(3, sigma3, dev), (1, 1))
    g5 = _gaussian_kernel1d(5, sigma5, dev)
    k1d = _sel(use5, g5.expand(len(use5), 5), g3p.expand(len(use5), 5))
    gauss_k = k1d.unsqueeze(2) * k1d.unsqueeze(1)
    half = _per(torch.where(use5.bool(), 2, 1), 2)
    yy = torch.arange(5, device=dev).view(1, 5, 1)
    xx = torch.arange(5, device=dev).view(1, 1, 5)
    inside = ((yy - 2).abs() <= half) & ((xx - 2).abs() <= half)
    lines = torch.stack([(yy == 2) & inside, (xx == 2) & inside,
                         (yy == xx) & inside, (yy == 4 - xx) & inside], 1).float()
    motion_k = lines[torch.arange(len(direction), device=dev), direction.long()]
    motion_k = motion_k / torch.sum(motion_k, dim=(1, 2), keepdim=True)
    return _sel(use_gauss, gauss_k, motion_k)


def apply_blur(img: torch.Tensor, apply, use_gauss, use5, direction) -> torch.Tensor:
    """OneOf{GaussianBlur, MotionBlur}: reflect padding, then one depthwise
    conv with each sample's kernel on its three channels."""
    b, h, w, c = img.shape
    kern = blur_kernels(use_gauss, use5, direction)
    x = F.pad(img.permute(0, 3, 1, 2).reshape(1, b * c, h, w), (2, 2, 2, 2), mode="reflect")
    weight = kern.repeat_interleave(c, 0).unsqueeze(1)          # [B*C, 1, 5, 5]
    blurred = F.conv2d(x, weight, groups=b * c).view(b, c, h, w).permute(0, 2, 3, 1)
    return _sel(apply, blurred, img)


# ------------------------------------------------------------------- policy

def apply_policy(p: Dict[str, torch.Tensor], images: torch.Tensor, masks: torch.Tensor,
                 eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole train policy (``augment_sample``) at the parameters `p`
    (``params_to``'s dict on the images' device) and noise `eps`."""
    img, mask = apply_flips(images, masks, p["do_h"], p["do_v"], p["rot_k"])
    img = apply_contrast(img, p["contrast"], p["use_clahe"], p["clip"], p["gamma"])
    img = apply_color(img, p["color"], p["use_bc"], p["alpha"], p["beta"],
                      p["jit_b"], p["jit_c"], p["jit_s"])
    img, mask = apply_affine(img, mask, p["affine"], p["scale"], p["tx"], p["ty"], p["theta"])
    img = apply_noise(img, p["noise"], p["var"], eps)
    img = apply_blur(img, p["blur"], p["use_gauss"], p["use5"], p["direction"])
    img, mask = apply_grid(img, mask, p["grid"], p["grid_x"], p["grid_y"])
    return img, mask


def augment_batch(generator: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                  eps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw a batch's parameters and its noise from `generator`, then apply
    the policy on the images' device.  [B,H,W,3], [B,H,W,C] -> same."""
    params = params_to(draw_params(generator, images.shape[0]), images.device)
    eps = gaussian_like(generator, images.shape, images.device, eps=eps)
    return apply_policy(params, images, masks, eps)
