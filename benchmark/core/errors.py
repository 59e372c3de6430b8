"""The error of a run that may print no result."""


class CellError(RuntimeError):
    """The run cannot report a result."""
