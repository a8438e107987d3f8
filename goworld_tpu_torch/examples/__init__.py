"""Example servers of the port (copies of the repo's ``examples/``)."""
