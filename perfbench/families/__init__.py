"""The port's models as benchmark jobs, one module a family."""
