from .guards import is_posdef, is_symmetric, safe_log, safe_acos, print_hyp
from .io import save_model, load_model
