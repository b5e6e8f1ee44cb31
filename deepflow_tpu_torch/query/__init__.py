"""Query layer: DF-SQL (``sql.py`` parser, ``engine.py`` executor,
``catalog.py`` SHOW and derived metrics) and the flame graphs
(``flamegraph.py``)."""
