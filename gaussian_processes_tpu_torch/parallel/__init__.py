from .mesh import make_mesh, population_shardings
from .population import (fit_cells_sequential, fit_population,
                         population_results)
from .large import large_cholesky, large_gram, large_posterior_mean
