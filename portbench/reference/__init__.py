"""Plain references that decide ``correct``.  They import nothing of the
port: each follows the published description of what it checks (the
policies' source semantics, Qwen3's layer equations and AdamW) in plain Python, NumPy or PyTorch."""
