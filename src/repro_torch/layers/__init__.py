"""Transformer layers: norms, RoPE, embedding, FFN, GQA attention."""
