"""A numpy model of ``csrc/clip_adamw.cu``: the norm kernel's chunk map and
fixed-order sums, and the update kernel's per-element arithmetic, in
float32 with every rounding explicit (no jax, no torch ops: the card's
tests import it too).

On the card the model equals torch's CUDA path bit for bit (``clip_`` then
the foreach AdamW: lerp, addcmul and addcdiv fused into one rounding each,
IEEE division and square root); torch's CPU kernels round otherwise in
places (their float32 sqrt is off by an ulp on some inputs, their addcdiv
computes (value m) / d, their addcmul fma(g, c2 g, v))."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from vaeunet_tpu_torch.ops.pallas import clip_adamw

f32, f64 = np.float32, np.float64


def fma32(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32: the float64 product is exact, the
    sum's error comes from TwoSum, and where the float64 sum is a float32
    midpoint the error's sign settles the rounding."""
    a, b, c = (np.asarray(x, dtype=f32).astype(f64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(f32)
    rd = r.astype(f64)
    toward = np.where(rd < s, np.inf, -np.inf).astype(f32)
    nb = np.nextafter(r, toward)
    mid = (rd != s) & ((rd + nb.astype(f64)) / 2 == s) & (e != 0)
    away = mid & (((e > 0) & (rd < s)) | ((e < 0) & (rd > s)))
    return np.where(away, nb, r).astype(f32)


def _f(x) -> np.ndarray:
    return np.asarray(x, dtype=f32)


def mul(a, b):
    return (_f(a) * _f(b)).astype(f32)


def add(a, b):
    return (_f(a) + _f(b)).astype(f32)


def sub(a, b):
    return (_f(a) - _f(b)).astype(f32)


def div(a, b):
    return (_f(a) / _f(b)).astype(f32)


def lerp(m, g, w):
    """torch's lerp(self=m, end=g, weight=w) on the card."""
    diff = sub(g, m)
    w = f32(w)
    if abs(w) < 0.5:
        return fma32(w, diff, m)
    return fma32(-diff, sub(f32(1), w), g)


def update(g, p, m, v, norm, max_norm: float, lr: float, weight_decay: float,
           betas: Tuple[float, float], eps: float, step: float):
    """One element-wise clip + AdamW step -> (g', p, m, v), float32; the
    scalars made in double as the host makes them."""
    beta1, beta2 = betas
    step_size, bc2_sqrt = clip_adamw.bias_corrections(beta1, beta2, lr, step)
    return update_kernel(g, p, m, v, norm, 1 - lr * weight_decay, 1 - beta1, beta2, 1 - beta2,
                         eps, max_norm, step_size, bc2_sqrt)


def update_kernel(g, p, m, v, norm, decay, w1, beta2, c2, eps, max_norm, step_size, bc2_sqrt):
    """The update kernel's ``update1`` on arrays, from its fp32 scalars."""
    decay, w1, beta2, c2, eps, max_norm, step_size, bc2_sqrt, norm = (
        f32(x) for x in (decay, w1, beta2, c2, eps, max_norm, step_size, bc2_sqrt, norm))
    g = _f(g)
    if not norm < max_norm:
        g = mul(div(g, norm), max_norm)
    p = mul(p, decay)
    m = lerp(m, g, w1)
    v = fma32(c2, mul(g, g), mul(v, beta2))
    d = add(div(np.sqrt(v).astype(f32), bc2_sqrt), eps)
    p = fma32(step_size, div(m, d), p)
    return g, p, m, v


def chunk_map(numels: Sequence[int]) -> np.ndarray:
    """Each tensor's first chunk, and the chunks in all last (``fill_map``
    in the source)."""
    chunks = [-(-int(n) // clip_adamw.CHUNK) for n in numels]
    return np.concatenate([[0], np.cumsum(chunks, dtype=np.int64)])


def grid(chunks: int, blocks: int) -> int:
    """A launch's blocks (``grid_of``): one a chunk up to `blocks`, at least one."""
    return max(1, min(chunks, blocks))


def _block_sum(v: np.ndarray) -> np.ndarray:
    """[..., 256] -> [...]: the kernel's block_sum (shuffles down in each
    warp, then the eight warps' sums in warp 0)."""
    w = v.reshape(*v.shape[:-1], 8, 32).copy()
    for o in (16, 8, 4, 2, 1):
        w[..., :o] = add(w[..., :o], w[..., o:2 * o])
    lanes = np.zeros((*v.shape[:-1], 32), dtype=f32)
    lanes[..., :8] = w[..., 0]
    for o in (16, 8, 4, 2, 1):
        lanes[..., :o] = add(lanes[..., :o], lanes[..., o:2 * o])
    return lanes[..., 0]


def _chunk_steps(g: np.ndarray, aligned: bool) -> np.ndarray:
    """One chunk's values as the threads take them: [steps, 256, 4], zeros
    where a thread takes none (fma(0, 0, s) = s)."""
    n = len(g)
    t = clip_adamw.THREADS
    if aligned:
        vecs = n // 4
        steps = -(-clip_adamw.CHUNK // (4 * t)) + 1
        out = np.zeros((steps, t, 4), dtype=f32)
        flat = out[:-1].reshape(-1, 4)
        flat[:vecs] = g[:4 * vecs].reshape(-1, 4)
        tail = g[4 * vecs:]
        out[-1, :len(tail), 0] = tail
        return out
    steps = -(-clip_adamw.CHUNK // t)
    lane0 = np.zeros(steps * t, dtype=f32)
    lane0[:n] = g
    out = np.zeros((steps, t, 4), dtype=f32)
    out[:, :, 0] = lane0.reshape(steps, t)
    return out


def norm(grads: Sequence[np.ndarray], aligned: Sequence[bool], blocks: int) -> np.float32:
    """The norm kernel's result for float32 gradients (flattened in memory
    order), `aligned` their 16-byte alignment, `blocks` the plan's most."""
    c0 = chunk_map([len(g) for g in grads])
    chunks = int(c0[-1])
    blocks = grid(chunks, blocks)
    t = clip_adamw.THREADS
    acc = np.zeros((blocks, t, 4), dtype=f32)
    for r in range(-(-chunks // blocks)):
        per_block = []
        for b in range(blocks):
            c = b + r * blocks
            if c >= chunks:
                per_block.append(None)
                continue
            k = int(np.searchsorted(c0, c, side="right")) - 1
            base = (c - int(c0[k])) * clip_adamw.CHUNK
            per_block.append(_chunk_steps(grads[k][base:base + clip_adamw.CHUNK], aligned[k]))
        depth = max(x.shape[0] for x in per_block if x is not None)
        vals = np.zeros((blocks, depth, t, 4), dtype=f32)
        for b, x in enumerate(per_block):
            if x is not None:
                vals[b, :x.shape[0]] = x
        for s in range(depth):
            acc = fma32(vals[:, s], vals[:, s], acc)
    partial = _block_sum(add(add(acc[..., 0], acc[..., 1]), add(acc[..., 2], acc[..., 3])))
    lanes = np.zeros(t, dtype=f32)
    for i in range(0, blocks, t):
        row = np.zeros(t, dtype=f32)
        row[:len(partial[i:i + t])] = partial[i:i + t]
        lanes = add(lanes, row)
    return np.sqrt(_block_sum(lanes)).astype(f32)
