from .lbfgs import lbfgs_minimize
