from .store import AsyncSaver, latest_step, restore, save
