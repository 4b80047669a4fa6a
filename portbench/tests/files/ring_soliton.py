"""ring_soliton, a real-wave phenomenon: a radial kink ring, or a
kink-antikink shell pair at radius +- width, with an optional angular
modulation (a frozen torch copy of the port's
pipeline/samplers/realwave2d.py:312-337 and its kink_primitive :36-61,
drawn to the same distribution). Returns (u0, v0) float64 on the grid's
device; the kink's form is the configuration's system's."""

import math

import torch

DSG_LAMBDA = 0.3        # the sampler's double sine-Gordon coupling


def _kink(system, xi, width, amplitude):
    """(u, s): a kink of argument xi and its slope factor (v = velocity *
    s)."""
    sech2 = 1.0 / torch.cosh(xi / width) ** 2
    if system in ("phi4", "klein_gordon"):
        return amplitude * torch.tanh(xi / width), amplitude / width * sech2
    if system == "double_sine_gordon":
        pref = math.sqrt((1 + DSG_LAMBDA) / DSG_LAMBDA)
        t = torch.tanh(math.sqrt(DSG_LAMBDA) * xi / (2 * width))
        return (4 * torch.atan(pref * t),
                4 * pref * math.sqrt(DSG_LAMBDA) / (2 * width) * (1 - t * t))
    u = 4 * torch.atan(torch.exp(xi / width))
    if system == "hyperbolic_sine_gordon":
        u = u - 2 * math.pi
    return u, 4 / width * sech2


def make(rng, p, X, L, cfg):
    del rng, L
    if len(X) != 2:
        raise ValueError("ring_soliton is a 2D phenomenon")
    system = cfg["system"]
    x0, y0 = p["position"]
    r = torch.sqrt((X[0] - x0) ** 2 + (X[1] - y0) ** 2)
    radius, width, amp, vel = (p["radius"], p["width"], p["amplitude"],
                               p["velocity"])
    if p["ring_type"] == "kink_antikink":
        u_in, s_in = _kink(system, radius - width - r, width / 2, amp)
        u_out, s_out = _kink(system, radius + width - r, width / 2, amp)
        u = u_in - u_out
        if system == "hyperbolic_sine_gordon":
            u = u - 2 * math.pi
        v = -vel * s_in + vel * s_out
    else:
        u, s = _kink(system, radius - r, width, amp)
        v = -vel * s
    if p["modulation_strength"] > 0:
        theta = torch.atan2(X[1] - y0, X[0] - x0)
        mod = 1 + p["modulation_strength"] * torch.cos(
            p["modulation_mode"] * theta)
        u, v = u * mod, v * mod
    return u, v
