"""Plain PyTorch references and the seeded inputs, one module a family."""
