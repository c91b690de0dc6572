from .solver import DisortInput, DisortOutput, disort  # noqa: F401
