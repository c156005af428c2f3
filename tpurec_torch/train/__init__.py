"""Training-side helpers the serving slice needs (tower selection, checkpoint reading)."""
