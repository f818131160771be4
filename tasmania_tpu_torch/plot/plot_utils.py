"""Animation helper (counterpart of ``tasmania_tpu/plot/plot_utils.py``)."""

from __future__ import annotations


class Animation:
    """Render a sequence of states into a movie file via a ``Plot`` monitor."""

    def __init__(self, artist, fps: int = 15) -> None:
        self._artist = artist
        self._fps = fps
        self._states = []

    def store(self, state) -> None:
        self._states.append(state)

    def run(self, save_dest: str) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(
            figsize=self._artist.figure_properties.get("figsize", (7, 7))
        )

        def frame(i):
            ax.clear()
            self._artist.store(self._states[i], fig=fig, ax=ax)
            return []

        anim = animation.FuncAnimation(
            fig, frame, frames=len(self._states), blit=False
        )
        anim.save(save_dest, fps=self._fps, writer="pillow")
