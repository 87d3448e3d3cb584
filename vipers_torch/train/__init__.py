"""Masked training: optimizer, EMA, train and eval steps, epoch loops."""
