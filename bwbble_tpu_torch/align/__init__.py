"""Alignment drivers: parameters, pipeline orchestration, evaluation."""
