"""Neuron graph layer: nodes, trace commits, trees and refinement."""
