"""Optimizers and int8 gradient compression over the port's parameter trees."""
