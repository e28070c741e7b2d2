"""Training substrate: optimizer, train step, data pipeline."""
