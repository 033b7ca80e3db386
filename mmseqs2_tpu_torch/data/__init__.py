from .submat import SubstitutionMatrix, get_matrix_text  # noqa: F401
