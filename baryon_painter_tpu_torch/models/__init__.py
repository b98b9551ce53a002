"""Model layer: layer DSL, eval-mode layers, CVAE."""
