"""Trajectory and reprojection metrics."""
