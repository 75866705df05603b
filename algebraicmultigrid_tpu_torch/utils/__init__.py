from . import arnoldi, symmetry
