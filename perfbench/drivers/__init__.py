"""One module a kind of cell, each with ``run(run)``; a cell file names
its driver."""
