"""Model compositions: the transformer composer and causal-LM heads."""
