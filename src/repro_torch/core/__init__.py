"""The paper's machinery in PyTorch: hashing, ticketing, resize, updates."""
