"""Equation models: nonlinearities, steppers, the trajectory loop, problems."""
