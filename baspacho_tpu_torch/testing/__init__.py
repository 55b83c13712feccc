from .utils import (
    print_pattern,
    print_aggreg_pattern,
    columns_to_lower_csr,
    csr_to_columns,
    naive_independent_elim_fill,
    naive_full_elim_fill,
    random_cols,
    random_spd_data,
    make_independent_elim_set,
)
from .mat_gen import SparseMatGenerator

__all__ = [
    "print_pattern",
    "print_aggreg_pattern",
    "columns_to_lower_csr",
    "csr_to_columns",
    "naive_independent_elim_fill",
    "naive_full_elim_fill",
    "random_cols",
    "random_spd_data",
    "make_independent_elim_set",
    "SparseMatGenerator",
]
