"""Serving over more than one device: the stream batch split over a mesh."""
