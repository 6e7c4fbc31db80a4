"""The device mesh of one process, its collectives and its arithmetic."""
