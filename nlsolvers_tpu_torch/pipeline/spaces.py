"""Curated phenomenon parameter spaces ("tested, don't diverge").

Data parity with finalized_scripts/valid_spaces_complex.py:9-141 and
valid_spaces_real.py:6-245: the values are the reference's vetted operating
points (they encode which ICs produce stable trajectories), kept as data.
Spec semantics are those of grids.resolve_param_ranges: list -> choice,
int tuple -> randint, float tuple -> uniform.
"""

import numpy as np

__all__ = ["nlse_parameter_spaces", "nlse_parameter_spaces_3d",
           "realwave_parameter_spaces", "realwave_parameter_spaces_3d"]

REALWAVE_SYSTEMS = ["sine_gordon", "double_sine_gordon",
                    "hyperbolic_sine_gordon", "phi4", "klein_gordon"]


def _grid_pairs(lo, hi, n):
    pts = np.linspace(lo, hi, n)
    return [(float(a), float(b)) for a in pts for b in pts]


def nlse_parameter_spaces():
    """valid_spaces_complex.py:9-74."""
    return {
        "multi_soliton": {
            "system_type": ["cubic", "cubic_quintic", "saturable",
                            "glasner_allen_flowers"],
            "width_range": [(0.5, 1.0), (1.0, 1.5), (1.5, 2.0)],
            "amplitude_range": [(0.5, 1.0), (1.0, 1.5), (1.5, 2.0)],
            "phase_pattern": ["random", "alternating", "synchronized",
                              "vortex"],
            "arrangement": ["linear", "circular", "random", "lattice"],
            "coherence": [0.2, 0.5, 0.8],
            "velocity_scale": [0.0, 0.5, 1.0],
            "chirp_range": [(-0.5, 0.0), (0.0, 0.5)],
            "aspect_ratio_range": [(1.0, 1.0), (1.0, 1.5)],
        },
        "vortex_lattice": {
            "amplitude": [0.5, 1.0, 1.5],
            "n_vortices": [3, 5, 7, 9],
            "arrangement": ["square", "triangular", "circular", "random"],
            "charge_distribution": ["alternating", "same", "random"],
            "apply_envelope": [False, True],
        },
        "ring_soliton": {
            "amplitude": [0.5, 1.0, 1.5],
            "radius": [1.0, 2.0, 3.0],
            "width": [0.3, 0.5, 0.8],
            "modulation_type": ["none", "azimuthal", "radial"],
            "modulation_strength": [0.0, 0.2, 0.4],
            "modulation_mode": [0, 1, 2],
            "apply_envelope": [False, True],
        },
        "multi_ring": {
            "amplitude_range": [(0.5, 1.0), (1.0, 1.5)],
            "radius_range": [(1.0, 3.0), (2.0, 5.0)],
            "width_range": [(0.3, 0.6), (0.5, 0.8)],
            "phase_pattern": ["random", "alternating", "synchronized",
                              "vortex"],
            "arrangement": ["linear", "circular", "random", "lattice",
                            "concentric"],
            "modulation_type": ["none", "azimuthal", "radial"],
            "modulation_strength": [0.0, 0.2, 0.4],
            "apply_envelope": [True],
        },
        "turbulent_condensate": {
            "amplitude": [0.5, 1.0, 1.5],
            "condensate_fraction": [0.3, 0.5, 0.7],
            "temperature": [0.5, 1.0, 1.5],
            "n_modes": [50, 100, 200],
            "spectrum_slope": [-1.0, -1.5, -2.0],
            "modulation_type": ["none", "spatial", "phase"],
            "modulation_strength": [0.0, 0.2, 0.4],
            "apply_envelope": [False, True],
        },
        "akhmediev_breather": {
            "amplitude": [0.5, 1.0, 1.5],
            "modulation_frequency": [1.0, float(np.pi)],
            "growth_rate": [1e-2, 0.1, 0.49],
            "breather_phase": ["compressed", "growing", "decaying"],
            "apply_envelope": [True, False],
            "t_param": [None, 1e-1, 2 / 3],
        },
    }


def nlse_parameter_spaces_3d():
    """valid_spaces_complex.py:77-141."""
    return {
        "multi_soliton_state": {
            "system_type": ["cubic"],
            "amplitude_range": [(0.5, 1.0), (0.8, 1.2), (1.0, 1.5),
                                (1.5, 2.0)],
            "width_range": [(0.5, 1.0), (0.8, 1.2), (1.0, 1.5), (1.5, 2.0)],
            "position_variance": [0.5, 1.0, 1.5, 2.0],
            "velocity_scale": [0.0, 0.2, 0.5, 1.0, 1.5],
            "phase_pattern": ["random", "alternating", "synchronized",
                              "vortex", "3d_vortex", "radial", "spiral",
                              "z_dependent", "partial_coherence"],
            "arrangement": ["linear", "planar_grid", "circular", "spherical",
                            "random", "lattice", "hierarchical"],
            "separation": [3.0, 5.0, 7.0, 10.0],
            "apply_envelope": [False],
            "envelope_width": [0.5, 0.7, 0.9],
            "Lambda_range": [(0.02, 0.08), (0.04, 0.14), (0.1, 0.2)],
            "coherence": [0.2, 0.5, 0.8, 1.0],
            "interaction_strength": [0.3, 0.5, 0.7, 1.0],
            "cluster_levels": [1, 2, 3, 4],
            "order_range": [(1, 2), (1, 3), (2, 3)],
            "chirp_range": [(-0.2, -0.1), (-0.1, 0.1), (0.0, 0.1),
                            (0.1, 0.2)],
            "aspect_ratio_x_range": [(1.0, 1.0), (1.0, 1.5), (1.5, 2.0)],
            "aspect_ratio_y_range": [(1.0, 1.0), (1.0, 1.5), (1.5, 2.0)],
            "phase_value": [0.0, np.pi / 4, np.pi / 2, np.pi,
                            3 * np.pi / 2],
        },
        "skyrmion_tube": {
            "amplitude_range": [(0.5, 1.0), (0.8, 1.5), (1.0, 2.0),
                                (1.5, 2.5)],
            "radius_range": [(0.5, 1.5), (1.0, 3.0), (2.0, 4.0),
                             (3.0, 5.0)],
            "width_range": [(0.3, 0.8), (0.5, 1.5), (1.0, 2.0), (1.5, 2.5)],
            "position_variance": [0.3, 0.5, 1.0, 1.5],
            "phase_range": [(0.0, float(np.pi)), (0.0, float(2 * np.pi)),
                            (float(np.pi / 2), float(3 * np.pi / 2))],
            "winding_range": [(1, 2), (1, 3), (2, 4)],
            "k_z_range": [(0.1, 0.5), (0.3, 0.8), (0.5, 1.0), (0.8, 1.5)],
            "velocity_scale": [0.0, 0.1, 0.3, 0.5, 0.8],
            "chirp_range": [(-0.2, -0.1), (-0.1, 0.1), (0.0, 0.1),
                            (0.1, 0.2)],
            "tube_count_range": [(1, 3), (2, 5), (3, 8)],
            "apply_envelope": [False],
            "envelope_width": [0.5, 0.7, 0.9],
            "tube_arrangement": ["random", "circular", "linear", "lattice"],
            "interaction_strength": [0.3, 0.5, 0.7, 1.0],
            "deformation_factor": [0.0, 0.1, 0.2, 0.3, 0.5],
        },
    }


def realwave_parameter_spaces(L):
    """valid_spaces_real.py:6-245 (positions scale with the domain size)."""
    return {
        "kink_solution": {
            "system_type": REALWAVE_SYSTEMS,
            "width": np.linspace(0.3, 3.0, 6).tolist(),
            "position": _grid_pairs(-L * 0.7, L * 0.7, 5),
            "orientation": np.linspace(0, 2 * np.pi, 8).tolist(),
            "velocity": _grid_pairs(-0.4, 0.4, 5),
            "kink_type": ["standard", "anti", "double"],
            "velocity_type": ["fitting", "zero", "grf"],
        },
        "kink_field": {
            "system_type": REALWAVE_SYSTEMS,
            "winding_x": list(range(-4, 5)),
            "winding_y": list(range(-4, 5)),
            "width_range": [(a, b) for a in [0.3, 0.5, 0.7]
                            for b in [1.5, 2.0, 3.0]],
            "randomize_positions": [True, False],
        },
        "kink_array_field": {
            "system_type": REALWAVE_SYSTEMS,
            "num_kinks_x": [1, 3, 5],
            "num_kinks_y": [1, 4, 8],
            "width_range": [(a, b) for a in [0.3, 0.5, 0.7]
                            for b in [1.5, 2.0, 3.0]],
            "jitter": [0.1, 0.4, 0.8],
        },
        "breather_solution": {
            "system_type": REALWAVE_SYSTEMS,
            "amplitude": np.linspace(0.1, 0.95, 9).tolist(),
            "frequency": np.linspace(0.3, 0.95, 7).tolist(),
            "width": np.linspace(0.3, 3.0, 6).tolist(),
            "position": _grid_pairs(-L * 0.7, L * 0.7, 4),
            "phase": np.linspace(0, 2 * np.pi, 8).tolist(),
            "orientation": np.linspace(0, 2 * np.pi, 8).tolist(),
            "breather_type": ["standard", "radial"],
            "time_param": [0.0],
            "velocity_type": ["fitting", "zero", "grf"],
        },
        "breather_field": {
            "system_type": REALWAVE_SYSTEMS,
            "num_breathers": list(range(2, 9)),
            "position_type": ["random", "circle", "line"],
            "time_param": [0.0, 0.5, 10.0],
        },
        "multi_breather_field": {
            "system_type": REALWAVE_SYSTEMS,
            "num_breathers": list(range(1, 4)),
            "position_type": ["line"],
            "amplitude_range": [(a, b) for a in [0.1, 0.2, 0.3, 0.4]
                                for b in [0.6, 0.7, 0.8, 0.9]],
            "width_range": [(a, b) for a in [0.3, 0.5, 0.7]
                            for b in [1.0, 1.5]],
            "frequency_range": [(a, b) for a in [0.3, 0.6, 0.7]
                                for b in [0.8, 0.9, 0.95]],
            "time_param": [0.0],
            "velocity_type": ["fitting", "zero", "grf"],
        },
        "ring_soliton": {
            "system_type": REALWAVE_SYSTEMS,
            "amplitude": np.linspace(0.5, 2.0, 4).tolist(),
            "radius": np.linspace(0.5, min(L * 0.6, 5.0), 8).tolist(),
            "width": np.linspace(0.2, 1.5, 7).tolist(),
            "position": _grid_pairs(-L * 0.3, L * 0.3, 3),
            "velocity": np.linspace(-0.3, 0.3, 7).tolist(),
            "ring_type": ["expanding", "kink_antikink"],
            "modulation_strength": np.linspace(0, 0.5, 6).tolist(),
            "modulation_mode": list(range(0, 8)),
            "time_param": np.linspace(0, 1.5, 4).tolist(),
        },
        "elliptical_soliton": {
            "system_type": REALWAVE_SYSTEMS,
            "complexity": ["complex", "simple"],
        },
        "multi_ring_state": {
            "system_type": REALWAVE_SYSTEMS,
            "n_rings": list(range(2, 8)),
            "radius_range": [(a, b) for a in [0.5, 1.0, 1.5]
                             for b in [2.5, 3.5, 4.5]],
            "width_range": [(a, b) for a in [0.2, 0.3, 0.4]
                            for b in [0.6, 0.8, 1.0]],
            "arrangement": ["concentric", "random", "circular"],
            "interaction_strength": np.linspace(0.3, 1.0, 5).tolist(),
            "modulation_strength": np.linspace(0, 0.5, 6).tolist(),
            "modulation_mode_range": [(a, b) for a in [1, 2, 3]
                                      for b in [4, 6, 8]],
        },
        "colliding_rings": {
            "system_type": REALWAVE_SYSTEMS,
            "num_rings": list(range(2, 4)),
            "ring_type": ["concentric", "nested", "random"],
            "amplitude": [1.0, 3.0],
        },
        "spiral_wave_field": {
            "num_arms": list(range(1, 9)),
            "decay_rate": np.linspace(0.2, 1.0, 5).tolist(),
            "amplitude": np.linspace(0.5, 2.0, 4).tolist(),
            "position": _grid_pairs(-L * 0.5, L * 0.5, 4),
            "phase": np.linspace(0, 2 * np.pi, 8).tolist(),
            "k_factor": np.linspace(0.5, 4.0, 8).tolist(),
        },
        "multi_spiral_state": {
            "n_spirals": np.linspace(1, 10, 5).astype(int).tolist(),
            "amplitude_range": [(a, b) for a in [0.1, 0.2, 0.3, 0.4]
                                for b in [0.6, 0.7, 0.8, 0.9]],
            "num_arms_range": [(1, 3), (3, 12), (1, 8)],
            "decay_rate_range": [(a, b) for a in [0.3, 0.6, 0.7]
                                 for b in [0.8, 0.9, 0.95]],
            "position_variance": [0.3, 1.0, 1.5],
            "interaction_strength": [1e-2, 0.3, 0.8],
        },
        "skyrmion_solution": {
            "system_type": REALWAVE_SYSTEMS,
            "amplitude": np.linspace(0.5, 2.0, 4).tolist(),
            "radius": np.linspace(0.3, 2.5, 6).tolist(),
            "position": _grid_pairs(-L * 0.5, L * 0.5, 4),
            "charge": [-2, -1, 1, 2],
            "profile": ["standard", "compact", "exponential"],
        },
        "skyrmion_lattice": {
            "system_type": REALWAVE_SYSTEMS,
            "n_skyrmions": [4, 7, 9, 12, 16, 25],
            "radius_range": [(a, b) for a in [0.3, 0.5, 0.7]
                             for b in [1.0, 1.5, 2.0]],
            "amplitude": np.linspace(0.5, 2.0, 4).tolist(),
            "arrangement": ["triangular", "square", "random"],
            "separation": np.linspace(1.5, 4.0, 6).tolist(),
            "charge_distribution": ["alternating", "random", "same"],
        },
        "skyrmion_like_field": {
            "num_skyrmions": list(range(2, 9)),
        },
        "q_ball_solution": {
            "system_type": REALWAVE_SYSTEMS,
            "position": [(float(x), float(y))
                         for x in np.linspace(-L * 0.5, L * 0.5, 10)
                         for y in np.linspace(-L * 0.5, L * 0.5, 10)],
            "phase": [0.0, 0.5],
            "frequency": [0.3, 0.8],
            "charge": [-1, 1],
        },
        "multi_q_ball": {
            "system_type": REALWAVE_SYSTEMS,
            "n_qballs": [2, 4, 8],
            "amplitude_range": [(0.1, 1.1), (0.5, 1.5)],
            "radius_range": [(0.5, 2.0), (0.1, 4.0)],
        },
        "soliton_antisoliton_pair": {
            "system_type": REALWAVE_SYSTEMS,
            "pattern_type": ["auto", "radial", "linear", "angular",
                             "nested"],
        },
        "grf_modulated_soliton_field": {
            "system_type": REALWAVE_SYSTEMS,
            "grf_length_scale": np.linspace(0.5, 3.0, 6).tolist(),
            "smoothness_scaling": np.linspace(0.5, 5.0, 5).tolist(),
            "anisotropy_ratio": [1.0, 1.5, 2.0, 3.0],
            "anisotropy_angle": np.linspace(0, np.pi, 4).tolist(),
            "construction_method": ["threshold", "level_set", "continuous"],
            "mixture_type": ["additive", "maximum", "blending"],
            "velocity_mode": ["zero", "fitting", "random"],
            "threshold_values": [[-1.0, 0.0, 1.0],
                                 [-2.0, -1.0, 0.0, 1.0, 2.0],
                                 [-1.5, -0.5, 0.5, 1.5]],
            "soliton_types": [["kink", "antikink"],
                              ["kink", "breather", "antikink"],
                              ["kink", "breather", "ring", "antikink"]],
            "level_set_width": [0.1, 0.2, 0.3, 0.5],
            "random_velocity_scale": np.linspace(0.1, 0.5, 5).tolist(),
        },
    }


def realwave_parameter_spaces_3d(L):
    """valid_spaces_real.py:247-268."""
    return {
        "kink_field": {
            "system_type": ["klein_gordon"],
            "winding_x": list(range(-4, 5)),
            "winding_y": list(range(-4, 5)),
            "winding_z": list(range(-4, 5)),
            "width_range": [(a, b) for a in [0.3, 0.5, 0.7]
                            for b in [1.5, 2.0, 3.0]],
            "randomize_positions": [True, False],
            "velocity_type": ["zero", "grf"],
        },
        "q_ball_soliton": {
            "omega": [0.3, 0.6, 0.8],
            "amplitude": [-0.2, 0.2, 0.45],
            "w": [0.1, 0.4, 0.5],
            "velocity_type": ["zero", "fitting"],
        },
    }
