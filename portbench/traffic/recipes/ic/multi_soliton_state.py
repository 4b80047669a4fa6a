"""multi_soliton_state, the 3D sweep's phenomenon: a superposition of
bright solitons (traffic/solitons.py), complex128 on the grid's device."""

from portbench.traffic.solitons import soliton_state


def make(rng, p, X, L, cfg):
    del cfg
    return soliton_state(rng, p, X, L)
