"""Few-shot learning pipeline (paper Fig. 1 / Fig. 5): backbone features →
NCM classification, with EASY-style augmented-shot ensembling."""
