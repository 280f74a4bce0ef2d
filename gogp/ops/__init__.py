from gogp.ops import distributed, iterative, linalg  # noqa: F401
