"""The guarded-command IR of ``tpuvsr/lower/`` (``ir.py`` only; the AST
compiler is not ported yet)."""
