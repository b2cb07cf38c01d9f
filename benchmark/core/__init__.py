"""The harness: manifest, closed-loop window, trace reduction, peaks."""
