'''
Tkinter GUI clients of the port (copies of kvarq_tpu/gui/, reference
kvarq/gui/): launcher with live log pane, scan wizard, result explorers
and canvas plot windows.  The scan wizard runs the port's engine, on the
card unless ``engine.config(device='cpu')`` was set.
'''


def lift_window(win):
    ''' raise a window above others (reference gui/__init__.py:6-12) '''
    win.lift()
    win.call('wm', 'attributes', '.', '-topmost', True)

    def after_lift():
        win.call('wm', 'attributes', '.', '-topmost', False)
    win.after_idle(after_lift)
