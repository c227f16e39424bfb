"""Cook-Torrance BRDF (pathtracer_fragment.glsl:282-334), as in
flexlight_tpu/ops/brdf.py, including the reference's non-standard choices
(F0 = albedo * mix(1, NdotV, metallic), inverse square on 1 + |lightDir|).
"""

from __future__ import annotations

import torch

from . import vec3 as v3
from .intersect import BIAS

PI = 3.141592653589793
INV_PI = 0.3183098861837907
SQRT3 = 1.7320508075688772


def pow5(x: torch.Tensor) -> torch.Tensor:
    """x ** 5 as XLA's integer_pow computes it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] rows to unit length."""
    n = v3.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])
    return v / torch.clamp_min(n, 1e-30)[..., None]


def trowbridge_reitz(alpha, n_dot_h):
    num = alpha * alpha
    denom = n_dot_h * n_dot_h * (num - 1.0) + 1.0
    return num / torch.clamp_min(PI * denom * denom, BIAS)


def schlick_beckmann(alpha, n_dot_x):
    k = alpha * 0.5
    denom = torch.clamp_min(n_dot_x * (1.0 - k) + k, BIAS)
    return n_dot_x / denom


def smith(alpha, n_dot_v, n_dot_l):
    return schlick_beckmann(alpha, n_dot_v) * schlick_beckmann(alpha, n_dot_l)


def fresnel(f0, theta):
    """Schlick approximation (glsl:299-302)."""
    return f0 + (1.0 - f0) * pow5(1.0 - theta)


def forward_trace(albedo, rme, light_dir, strength, n, v):
    """Direct light of one light (glsl:304-334) on [..., 3] rows: light_dir
    unnormalized toward the light, n the shading normal, v the unit vector
    toward the viewer. Returns [..., 3] radiance."""
    out = forward_trace_soa(
        v3.unstack3(albedo), rme[..., 0], rme[..., 1], rme[..., 2],
        v3.unstack3(light_dir), strength, v3.unstack3(n), v3.unstack3(v))
    return v3.stack3(out)


def forward_trace_soa(albedo, rough, metal, emis, light_dir, strength, n, v):
    """Direct light of one light (glsl:304-334). albedo/light_dir/n/v are
    (x, y, z) tuples of [N] tensors, rough/metal [N]; returns a 3-tuple."""
    len_p1 = 1.0 + v3.norm3(light_dir)
    brightness = strength / (len_p1 * len_p1)

    l = v3.normalize3(light_dir)
    h = v3.normalize3(v3.add3(v, l))

    v_dot_h = torch.clamp_min(v3.dot3(v, h), 0.0)
    n_dot_l = torch.clamp_min(v3.dot3(n, l), 0.0)
    n_dot_h = torch.clamp_min(v3.dot3(n, h), 0.0)
    n_dot_v = torch.clamp_min(v3.dot3(n, v), 0.0)

    alpha = rough * rough
    brdf = 1.0 + (n_dot_v - 1.0) * metal
    one_m_theta5 = pow5(1.0 - v_dot_h)
    ct = (trowbridge_reitz(alpha, n_dot_h) * smith(alpha, n_dot_v, n_dot_l)
          / torch.clamp_min(4.0 * n_dot_v * n_dot_l, BIAS))
    gain = n_dot_l * brightness
    out = []
    for c in albedo:
        f0 = c * brdf
        ks = f0 + (1.0 - f0) * one_m_theta5
        kd = (1.0 - ks) * (1.0 - metal)
        out.append((kd * c * INV_PI + ks * ct) * gain)
    return tuple(out)
