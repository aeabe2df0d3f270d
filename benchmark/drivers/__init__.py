"""The general loops that traffic mixes name (``traffic/<mix>.json``'s
``driver``): each module's ``run(ctx)`` sets up the program, runs the window
or the traced stretch, and makes the check."""
