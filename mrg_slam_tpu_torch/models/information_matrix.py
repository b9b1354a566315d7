"""Edge information weighting (src/mrg_slam/information_matrix_calculator.cpp).

Either a constant diagonal, or fitness-score-driven interpolation of the
variance between (min_stddev^2, max_stddev^2):

    y(x)   = (1 - e^{-a x}) / (1 - e^{-a thresh})
    var(x) = min_var + (max_var - min_var) * y(x)
    info   = I6 with translation block 1/var_x, rotation block 1/var_q

Quirk preserved from the reference (:19-23): the constant path divides by
the *stddev*, not the variance. A copy of the JAX package's
models/information_matrix.py; the fitness pass runs the nn kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import InformationMatrixConfig
from ..ops.cloud import PointCloud
from ..ops.fitness import fitness_score


class InformationMatrixCalculator:
    def __init__(self, cfg: InformationMatrixConfig):
        self.cfg = cfg

    @staticmethod
    def weight(a: float, max_x: float, min_y: float, max_y: float,
               x: float) -> float:
        y = (1.0 - math.exp(-a * x)) / (1.0 - math.exp(-a * max_x))
        return min_y + (max_y - min_y) * y

    def from_fitness(self, fitness: float) -> np.ndarray:
        c = self.cfg
        if c.use_const_inf_matrix:
            inf = np.eye(6)
            inf[:3, :3] /= c.const_stddev_x
            inf[3:, 3:] /= c.const_stddev_q
            return inf.astype(np.float32)
        min_var_x, max_var_x = c.min_stddev_x ** 2, c.max_stddev_x ** 2
        min_var_q, max_var_q = c.min_stddev_q ** 2, c.max_stddev_q ** 2
        w_x = self.weight(c.var_gain_a, c.fitness_score_thresh, min_var_x,
                          max_var_x, fitness)
        w_q = self.weight(c.var_gain_a, c.fitness_score_thresh, min_var_q,
                          max_var_q, fitness)
        inf = np.eye(6)
        inf[:3, :3] /= w_x
        inf[3:, 3:] /= w_q
        return inf.astype(np.float32)

    def clamp_fitness(self, fit: float) -> float:
        """Non-finite fitness (no correspondences) degrades to the threshold
        — the reference's max-double fallback saturates the same way."""
        return fit if math.isfinite(fit) else self.cfg.fitness_score_thresh

    def calc_information_matrix(self, cloud1: PointCloud, cloud2: PointCloud,
                                relpose: np.ndarray) -> np.ndarray:
        if self.cfg.use_const_inf_matrix:
            return self.from_fitness(0.0)
        rel = torch.as_tensor(np.asarray(relpose, np.float32),
                              device=cloud1.points.device)
        fit = float(fitness_score(cloud1, cloud2, rel))  # one host read
        return self.from_fitness(self.clamp_fitness(fit))
