"""One module a program entry point (a configuration's ``entry``): builds
the work a cell's window repeats, and the reference run it is held to."""
